"""Distributed enumeration: AIRA workers partitioned over a device mesh.

This is the multi-chip form of the whole enumeration (not just one solve
round): the synergistic worker set is split into per-device *domains*, the
shared-memory cells that would span domains are severed (each domain gets
its own replica — sharing only ever prunes, so severing is always sound),
and the cross-domain exchange happens exclusively through the mesh
collective (`parallel/mesh.py:make_bound_exchange`) at round boundaries:

  every round:  each domain's workers yield their CLMOIP subproblems
                → one backend batch solves all domains' subproblems
                  (the wave backend additionally shards its LP waves over
                  the same mesh)
                → the collective allgathers each domain's NEW infeasible
                  boxes into every other domain's infeasibles store, and
                  pmin/pmax-reduces solved objective values
                → after round 1 the reduced values are the exact ideal
                  point (every objective is led by some worker's first
                  unconstrained solve), from which each domain inserts
                  "beyond the ideal point" infeasibility cuts.

Reference parity: one OS process per thread group with shared-memory cells
(aira.cpp:923-1551) becomes domains + collectives; the shared ``infeasibles``
list (the reference's only cross-worker store, aira.cpp:816-827) becomes the
allgather payload.  Feasible lex results stay domain-private because they are
permutation-dependent — exactly why the reference keeps per-thread private
solution stores too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from moip_aira_tpu.core.store import Solutions
from moip_aira_tpu.engine.worker import aira_worker
from moip_aira_tpu.engine.worker_spec import Cell, LockGroup, WorkerSpec
from moip_aira_tpu.parallel.cluster import build_cluster
from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense
from moip_aira_tpu.solver.lex import LexRequest

#: padding sentinel for the exchange value batch
_BIGVAL = float(2**52)


def partition_specs(
    specs: Sequence[WorkerSpec], n_domains: int
) -> List[List[WorkerSpec]]:
    """Contiguous near-even split: with spreading, consecutive workers sit
    in the same ordering subtree, so contiguous blocks minimise severed
    cells (the reference's top-level cluster boundary becomes the device
    boundary)."""
    n = len(specs)
    out: List[List[WorkerSpec]] = []
    base, extra = divmod(n, n_domains)
    i = 0
    for d in range(n_domains):
        take = base + (1 if d < extra else 0)
        out.append(list(specs[i : i + take]))
        i += take
    return out


def sever_cross_domain_cells(groups: List[List[WorkerSpec]]) -> int:
    """Replace every Cell/LockGroup referenced from more than one domain
    with per-domain replicas.  Returns the number of severed objects.

    Severing is sound: shared cells only ever let a worker *skip* regions a
    partner has completely enumerated; a severed (private) cell simply
    prunes less.  Cross-domain pruning is reintroduced by the collective
    exchange, which carries only permutation-independent facts.
    """
    owners: dict = {}
    for d, group in enumerate(groups):
        for spec in group:
            for table in (
                spec.share_to,
                spec.share_from,
                spec.share_bounds,
                spec.share_limit,
                spec.locks,
            ):
                for obj in table:
                    if obj is not None:
                        owners.setdefault(id(obj), (obj, set()))[1].add(d)
    clones: dict = {}
    severed = 0
    for oid, (obj, doms) in owners.items():
        if len(doms) <= 1:
            continue
        severed += 1
        if isinstance(obj, Cell):
            clones[oid] = {d: Cell(obj.value) for d in doms}
        else:
            clones[oid] = {d: LockGroup() for d in doms}
    for d, group in enumerate(groups):
        for spec in group:
            for table in (
                spec.share_to,
                spec.share_from,
                spec.share_bounds,
                spec.share_limit,
                spec.locks,
            ):
                for i, obj in enumerate(table):
                    if obj is not None and id(obj) in clones:
                        table[i] = clones[id(obj)][d]
    return severed


class MeshScheduler:
    """Runs the full enumeration with workers distributed over a mesh."""

    def __init__(
        self,
        problem: Problem,
        backend,
        mesh,
        exchange: bool = True,
        slots: int = 32,
        mode: str = "strip",
    ):
        #: ``mode``: "strip" (default) distributes EPP strips — domains own
        #: DISJOINT objective ranges, so total IPs stay ~flat as the mesh
        #: grows; "sync" distributes synergistic workers with severed cells
        #: (round-4 measurement: severing multiplies IPs 2.2x at mesh=8 —
        #: kept for A/B and for workloads needing permutation diversity).
        self.problem = problem
        self.backend = backend
        self.mesh = mesh
        self.exchange = exchange
        self.slots = slots
        self.mode = mode
        self.ip_count = 0
        self.rounds = 0
        self.batch_sizes: List[int] = []
        self.exchanged_boxes = 0
        #: per-domain IP counts — on real multi-chip hardware each domain's
        #: round batch runs on its own device, so wall time tracks
        #: pre_ips + max(domain_ips) (the critical path), not the total
        self.domain_ips: List[int] = []
        self.pre_ips = 0
        #: boxes that exceeded the per-round slot budget and were DEFERRED
        #: to the next round (cumulative; round-2's silent truncation —
        #: `new_boxes[d][:S]` dropped the tail outright — is fixed by the
        #: per-domain carry queues below)
        self.carried_boxes = 0
        self.severed = 0
        self._ex_fn = None
        self._carry: List[np.ndarray] = []
        #: collective array rows per domain: must fit every worker's ROUND-1
        #: solved value (the pmin/pmax ideal-point leg), independent of the
        #: per-round box quota `slots` (run() sizes it)
        self._ex_slots = slots

    def _drain_pending(self, d: int, new: np.ndarray) -> np.ndarray:
        """Queue `new` boxes behind domain d's carried backlog and return
        at most `slots` to ship this round; the remainder carries over
        (counted in `carried_boxes`) so every box eventually propagates."""
        k = self.problem.objcnt
        while len(self._carry) <= d:
            self._carry.append(np.zeros((0, k)))
        pend = (
            np.vstack([self._carry[d], new]) if len(self._carry[d]) else new
        )
        send = pend[: self.slots]
        self._carry[d] = pend[self.slots :]
        self.carried_boxes += len(self._carry[d])
        return send

    # -- collective plumbing ------------------------------------------------
    def _exchange_round(
        self,
        new_boxes: List[np.ndarray],
        round_vals: List[np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run the compiled collective; returns (boxes, flags, lo/hi)."""
        import jax.numpy as jnp

        from moip_aira_tpu.parallel.mesh import make_bound_exchange, shard_batch

        k = self.problem.objcnt
        D = self.mesh.size
        S = self._ex_slots
        if self._ex_fn is None:
            self._ex_fn = make_bound_exchange(self.mesh, k, S)
        boxes = np.zeros((D * S, k), dtype=np.float64)
        flags = np.zeros((D * S,), dtype=np.int32)
        vals = np.zeros((D * S, k), dtype=np.float64)
        vflags = np.zeros((D * S,), dtype=np.int32)
        for d in range(D):
            nb = new_boxes[d][:S] if d < len(new_boxes) else np.zeros((0, k))
            # replace ±inf with the collective's finite sentinel
            boxes[d * S : d * S + len(nb)] = np.clip(nb, -_BIGVAL, _BIGVAL)
            flags[d * S : d * S + len(nb)] = 1
            rv = round_vals[d][:S] if d < len(round_vals) else np.zeros((0, k))
            if len(rv):
                vals[d * S : d * S + len(rv)] = rv
                vflags[d * S : d * S + len(rv)] = 1
        all_boxes, all_flags, lo, hi = self._ex_fn(
            shard_batch(self.mesh, jnp.asarray(boxes)),
            shard_batch(self.mesh, jnp.asarray(flags)),
            shard_batch(self.mesh, jnp.asarray(vals)),
            shard_batch(self.mesh, jnp.asarray(vflags)),
        )
        return (
            np.asarray(all_boxes),
            np.asarray(all_flags),
            (np.asarray(lo)[0], np.asarray(hi)[0]),
        )

    # -- main entry ---------------------------------------------------------
    def run(
        self,
        n_workers: int,
        spread: bool,
        all_store: Solutions,
        infeasibles_unused: Optional[Solutions] = None,
    ) -> Solutions:
        """Distribute ``n_workers`` workers over the mesh and enumerate to
        completion; fronts merge into ``all_store``.  Dispatches on
        ``self.mode`` (strip = EPP range distribution, sync = synergistic
        workers with severed cells)."""
        if self.mode == "strip":
            return self.run_strips(n_workers, all_store)
        return self.run_sync(n_workers, spread, all_store)

    def run_sync(
        self,
        n_workers: int,
        spread: bool,
        all_store: Solutions,
    ) -> Solutions:
        """Synergistic-worker distribution (the round-2..4 design)."""
        p = self.problem
        k = p.objcnt
        D = self.mesh.size
        is_min = p.objsen is Sense.MIN

        specs = build_cluster(n_workers, k, p.objsen, spread)
        groups = partition_specs(specs, min(D, len(specs)))
        self.domain_ips = [0] * len(groups)
        self.severed = sever_cross_domain_cells(groups)
        # round 1 must carry every worker's first solve through the
        # pmin/pmax leg for the ideal point to be exact (the BOX quota
        # `slots` is independent: boxes beyond it carry over to later
        # rounds via _drain_pending)
        self._ex_slots = max(self.slots, max(len(g) for g in groups))

        # per-domain stores: domain feasible store + domain infeasibles
        dom_store = [Solutions(k) for _ in groups]
        dom_inf = [Solutions(k) for _ in groups]
        #: which objectives' ideal coordinates round 1 determines exactly
        lead_objs = {spec.perm[0] for spec in specs}

        live: List[list] = []  # [domain, spec, gen, pending_rhs]
        for d, group in enumerate(groups):
            for spec in group:
                g = aira_worker(p, spec, dom_store[d], dom_inf[d])
                try:
                    rhs = next(g)
                    live.append([d, spec, g, rhs])
                except StopIteration:
                    pass

        inf_sizes = [len(s) for s in dom_inf]
        ideal_done = False

        while live:
            self.rounds += 1
            reqs = [
                LexRequest(rhs=item[3], perm=item[1].perm) for item in live
            ]
            self.batch_sizes.append(len(reqs))
            outcomes = self.backend.lex_solve_batch(reqs)

            round_vals: List[List[np.ndarray]] = [[] for _ in groups]
            nxt = []
            for item, out in zip(live, outcomes):
                d, spec, g, _ = item
                self.ip_count += out.ip_solves
                self.domain_ips[d] += out.ip_solves
                if out.result is not None:
                    round_vals[d].append(np.asarray(out.result, dtype=np.float64))
                reply = (out.status.is_infeasible, out.result)
                try:
                    rhs = g.send(reply)
                    nxt.append([d, spec, g, rhs])
                except StopIteration:
                    pass
            live = nxt

            if self.exchange and len(groups) > 1:
                new_boxes = []
                for d, s in enumerate(dom_inf):
                    lo_i = inf_sizes[d]
                    fresh = np.array(
                        s._ips[lo_i : len(s)], dtype=np.float64
                    ).reshape(-1, k)
                    # at most `slots` ship per round; the rest queues for
                    # the next round instead of being dropped (r2 weak #5)
                    new_boxes.append(self._drain_pending(d, fresh))
                vals_in = [
                    np.array(v, dtype=np.float64).reshape(-1, k)
                    for v in round_vals
                ]
                boxes, flags, (lo, hi) = self._exchange_round(new_boxes, vals_in)
                # merge foreign infeasible boxes into every domain
                for row in np.flatnonzero(flags == 1):
                    src_dom = int(row) // self._ex_slots
                    for d in range(len(groups)):
                        if d == src_dom:
                            continue
                        self.exchanged_boxes += 1
                        dom_inf[d].insert(boxes[row], None, True)
                # ideal-point cuts: after round 1 the reduced extremes are
                # exact for every objective some worker leads with
                if not ideal_done and self.rounds == 1:
                    ideal_done = True
                    ideal = lo if is_min else hi
                    for j in sorted(lead_objs):
                        if abs(ideal[j]) >= _BIGVAL / 2:
                            continue
                        box = np.full(k, INF if is_min else -INF)
                        box[j] = ideal[j] - 1 if is_min else ideal[j] + 1
                        for d in range(len(groups)):
                            dom_inf[d].insert(box, None, True)
                inf_sizes = [len(s) for s in dom_inf]

        for s in dom_store:
            if isinstance(all_store, Solutions):
                all_store.merge(s)
            else:  # e.g. the native C++ store: generic insert path
                for i in range(len(s)):
                    all_store.insert(
                        s._ips[i],
                        None if s._infeasible[i] else s._results[i],
                        bool(s._infeasible[i]),
                    )
        return all_store

    def run_strips(
        self,
        n_workers: int,
        all_store: Solutions,
        split_normal: bool = False,
    ) -> Solutions:
        """EPP-strip distribution (the default mesh mode).

        Domains own DISJOINT contiguous ranges of the last objective
        (the reference's own `--split` decomposition, aira.cpp:1886-1990,
        mapped onto device domains), so no domain re-enumerates another's
        region and total IPs stay ~flat as the mesh grows — where the
        severed-cell sync mode multiplied IPs 2.2x at mesh=8 (BENCH_MESH
        round 4).  The collective still propagates (a) each round's new
        infeasible boxes — a strip's bound is part of the rhs box vector,
        so an infeasible box is a GLOBALLY valid fact any domain's
        relaxation lookup can hit — and (b) the round-1 ideal point.
        """
        from moip_aira_tpu.engine.scheduler import Scheduler
        from moip_aira_tpu.parallel.split import (
            build_strip_specs,
            get_limit,
            split_setup,
        )

        p = self.problem
        k = p.objcnt
        D = self.mesh.size
        is_min = p.objsen is Sense.MIN

        # range measurement: the reference's recursive lower-level
        # enumeration (shared pre-work; a real deployment runs it once and
        # broadcasts — here it runs undistributed on the same backend)
        pre = Scheduler(p, self.backend)
        pre_inf = Solutions(k)
        sols = (
            split_setup(pre, k - 1, n_workers, split_normal, pre_inf)
            if k > 1
            else []
        )
        _status, res = get_limit(pre, k - 1)
        self.ip_count += pre.ip_count
        self.pre_ips = pre.ip_count
        self.rounds += pre.rounds
        if res is None:
            return all_store
        if is_min:
            smallest = float(res[k - 1])
            biggest = max((float(s[k - 1]) for s in sols), default=-INF)
            if biggest == smallest:
                biggest = INF
        else:
            biggest = float(res[k - 1])
            smallest = min((float(s[k - 1]) for s in sols), default=INF)
            if biggest == smallest:
                smallest = -INF

        specs = build_strip_specs(
            p, k, biggest, smallest, n_workers, split_normal
        )
        groups = partition_specs(specs, min(D, len(specs)))
        self.domain_ips = [0] * len(groups)
        self._ex_slots = max(self.slots, max(len(g) for g in groups))

        dom_store = [Solutions(k) for _ in groups]
        dom_inf = [Solutions(k) for _ in groups]
        # pre-work infeasible boxes are global facts: seed every domain
        for d in range(len(groups)):
            for i in range(len(pre_inf)):
                dom_inf[d].insert(pre_inf._ips[i], None, True)

        live: List[list] = []
        for d, group in enumerate(groups):
            for spec in group:
                # split workers insert straight into the domain store
                # (worker.py: s = all_store when split)
                g = aira_worker(p, spec, dom_store[d], dom_inf[d])
                try:
                    rhs = next(g)
                    live.append([d, spec, g, rhs])
                except StopIteration:
                    pass

        inf_sizes = [len(s) for s in dom_inf]
        ideal_done = False
        while live:
            self.rounds += 1
            reqs = [
                LexRequest(rhs=item[3], perm=item[1].perm) for item in live
            ]
            self.batch_sizes.append(len(reqs))
            outcomes = self.backend.lex_solve_batch(reqs)

            round_vals: List[List[np.ndarray]] = [[] for _ in groups]
            nxt = []
            for item, out in zip(live, outcomes):
                d, spec, g, _ = item
                self.ip_count += out.ip_solves
                self.domain_ips[d] += out.ip_solves
                if out.result is not None:
                    round_vals[d].append(
                        np.asarray(out.result, dtype=np.float64)
                    )
                reply = (out.status.is_infeasible, out.result)
                try:
                    rhs = g.send(reply)
                    nxt.append([d, spec, g, rhs])
                except StopIteration:
                    pass
            live = nxt

            if self.exchange and len(groups) > 1:
                new_boxes = []
                for d, s in enumerate(dom_inf):
                    lo_i = inf_sizes[d]
                    fresh = np.array(
                        s._ips[lo_i : len(s)], dtype=np.float64
                    ).reshape(-1, k)
                    new_boxes.append(self._drain_pending(d, fresh))
                vals_in = [
                    np.array(v, dtype=np.float64).reshape(-1, k)
                    for v in round_vals
                ]
                boxes, flags, (lo, hi) = self._exchange_round(
                    new_boxes, vals_in
                )
                for row in np.flatnonzero(flags == 1):
                    src_dom = int(row) // self._ex_slots
                    for d in range(len(groups)):
                        if d == src_dom:
                            continue
                        self.exchanged_boxes += 1
                        dom_inf[d].insert(boxes[row], None, True)
                if not ideal_done and self.rounds >= 1:
                    # identity perms: round 1 pins objective 0's ideal
                    ideal_done = True
                    ideal = lo if is_min else hi
                    if abs(ideal[0]) < _BIGVAL / 2:
                        box = np.full(k, INF if is_min else -INF)
                        box[0] = ideal[0] - 1 if is_min else ideal[0] + 1
                        for d in range(len(groups)):
                            dom_inf[d].insert(box, None, True)
                inf_sizes = [len(s) for s in dom_inf]

        # reference parity with the single-host split path
        # (api.solve_front split branch): strip results enter the global
        # store with a dead ip vector that never answers relaxations
        dead_ip = np.full(k, -INF if is_min else INF)
        for s in dom_store:
            for row in s.feasible_points():
                all_store.insert(dead_ip, row, False)
        return all_store
