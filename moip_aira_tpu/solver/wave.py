"""Wave backend: host-orchestrated branch-and-bound over batched device LPs.

The LP relaxation is the device kernel — the vmapped ``lax.while_loop``
simplex of simplex_jax.py, compiled by XLA — and the branch-and-bound tree
search runs on the host:

  wave loop:  gather up to ``batch_width`` open nodes across every active
              (worker, lex-stage) task  →  one async device call solves all
              their LP relaxations (float32)  →  certify every result
              exactly in float64 from the returned bases (solver/verify.py)
              →  prune / bound / branch on host  →  repeat,
              with up to two waves in flight so host work hides device time.

Because nodes from *all* AIRA workers, all EPP strips and all lexicographic
stages share one batch, the device stays full even though each individual
B&B tree is sequential — the same trick the scheduler plays one level up.
MIP machinery on the host side: previous-stage warm incumbents, rounding +
1-swap local search (solver/heuristics.py) and reduced-cost fixing from the
exact certificate duals.

This mirrors how the reference extracts parallelism from CPLEX threads
(aira.cpp:236-239 `-c`): intra-solve parallelism, but as SIMD lanes instead
of threads.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense
from moip_aira_tpu.solver import simplex_jax as sx
from moip_aira_tpu.solver.lex import LexOutcome, LexRequest, NumpyLexBackend
from moip_aira_tpu.solver.status import SolveStatus
from moip_aira_tpu.utils.device import enable_compile_cache

INT_TOL = 1e-6


class _StageTask:
    """One single-objective MIP (one lexicographic stage of one request)."""

    __slots__ = (
        "req_idx",
        "stage",
        "obj_j",
        "c_struct",
        "obj_int",
        "srhs",
        "nodes",
        "best",
        "best_x",
        "node_count",
        "failed",
        "cvec",
        "llo",
        "lhi",
        "ls_budget",
        "fix_d",
        "inflight",
    )

    def __init__(self, req_idx, stage, obj_j, c_struct, obj_int, srhs, lb, ub):
        self.req_idx = req_idx
        self.stage = stage
        self.obj_j = obj_j
        self.c_struct = c_struct
        self.obj_int = obj_int
        self.srhs = srhs
        # DFS stack of (lo, hi, parent_bound); parent_bound is a valid f64
        # lower bound on every solution in the node (its parent's certified
        # LP bound) — checked against the incumbent at SUBMIT time, so nodes
        # created before a better incumbent arrived are dropped without a
        # device solve.
        self.nodes: List = [(lb.copy(), ub.copy(), -np.inf)]
        self.best = np.inf
        self.best_x: Optional[np.ndarray] = None
        self.node_count = 0
        self.failed = False
        self.cvec = None  # (nc,) objective vector incl. logical zeros
        self.llo = None  # logical lower bounds for this stage's srhs
        self.lhi = None
        self.ls_budget = 4  # local-search polish calls for this MIP
        self.fix_d = True  # reduced-cost fixing enabled
        self.inflight = 0  # nodes currently inside an unprocessed wave


class WaveLexBackend:
    """Exact lexicographic CLMOIP solves via device LP waves."""

    name = "wave"

    def __init__(
        self,
        problem: Problem,
        batch_width: int = 256,
        nodes_per_task: int = 8,
        lp_max_iters: int = 2000,
        max_nodes: int = 500000,
        dtype: str = "float32",
        mesh=None,
    ):
        jax.config.update("jax_enable_x64", True)
        enable_compile_cache()
        self.problem = problem
        self.batch_width = batch_width
        self.nodes_per_task = nodes_per_task
        self.max_nodes = max_nodes
        self.f32 = dtype == "float32"
        self.mesh = mesh
        if mesh is not None and batch_width % mesh.size != 0:
            raise ValueError(
                f"batch_width {batch_width} must divide evenly over the "
                f"{mesh.size}-device mesh"
            )

        p = problem
        self.k = p.objcnt
        self.n = p.n
        self.m = p.m_total
        self.is_min = p.objsen is Sense.MIN
        A_full = np.vstack([p.A, p.C])
        self._A_full = A_full
        W_np = np.hstack([A_full, -np.eye(self.m)])
        if self.f32:
            # fast on-device arithmetic; every result certified in f64 below
            W = jnp.asarray(W_np, dtype=jnp.float32)
            # f32 tolerances sized to the accumulation noise of this data
            # (coeffs up to ~1e2, sums over ~m terms => |d| noise ~1e-2);
            # anything the loose tolerances get wrong is caught by the f64
            # certificates and re-solved exactly on host.
            lp = sx.make_lp_solver(
                W, lp_max_iters, feas_tol=1e-2, cost_tol=1e-2, pivot_tol=1e-3,
                progress_tol=1e-3,
            )
        else:
            W = jnp.asarray(W_np)
            lp = sx.make_lp_solver(W, lp_max_iters)
        self._dtype = jnp.float32 if self.f32 else jnp.float64
        from moip_aira_tpu.solver.verify import LPVerifier

        self._verifier = LPVerifier(W_np) if self.f32 else None
        self._ws = None  # lazy SimplexWorkspace for per-lane exact fallback
        #: lanes re-solved by the exact f64 host simplex (failed certificate
        #: or iteration-limited device LP)
        self.verify_fallbacks = 0
        #: lex requests re-solved whole by the host B&B (resource trouble)
        self.req_fallbacks = 0
        #: device lanes whose f64 certificate failed
        self.cert_failures = 0
        #: pivot-loop iterations: each wave's slowest lane (the batched
        #: while-loop runs that many), and all real lanes together
        self.wave_iters = 0
        self.lane_iters = 0
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            axes = tuple(mesh.axis_names)
            bsh = NamedSharding(mesh, P(axes, None))
            inner = jax.jit(jax.vmap(lp), in_shardings=(bsh, bsh, bsh))
        else:
            inner = jax.jit(jax.vmap(lp))
        dt = self._dtype

        def _run_xla(c, lo, hi):
            clh = jnp.asarray(np.stack([c, lo, hi]), dtype=dt)
            return inner(clh[0], clh[1], clh[2])

        self._lp_batch = _run_xla
        self.int_idx = np.flatnonzero(p.is_int)
        self.obj_integral = np.array(
            [
                bool(
                    np.all(p.C[j] == np.rint(p.C[j]))
                    and np.all(p.is_int[np.abs(p.C[j]) > 0])
                )
                for j in range(p.objcnt)
            ]
        )
        self.device_waves = 0
        self.lp_count = 0
        self._fallback = NumpyLexBackend(problem)

    # -- stage plumbing ----------------------------------------------------
    def _assign_struct(self, glo, ghi):
        """Cached assignment-structure detection (heuristics.detect_assignment).

        The equality structure lives in the STRUCTURAL rows (identical for
        every stage task — objective-bound rows are always inequalities),
        so one detection serves the whole solve."""
        if not hasattr(self, "_assign_struct_cache"):
            from moip_aira_tpu.solver.heuristics import detect_assignment

            self._assign_struct_cache = detect_assignment(
                self._A_full, glo, ghi
            )
        return self._assign_struct_cache

    def _stage_task(self, req_idx, stage, perm, srhs, x_warm=None) -> _StageTask:
        j = perm[stage]
        sign = 1.0 if self.is_min else -1.0
        t = _StageTask(
            req_idx,
            stage,
            j,
            sign * self.problem.C[j],
            self.obj_integral[j],
            srhs,
            self.problem.lb,
            self.problem.ub,
        )
        t.cvec = np.concatenate([t.c_struct, np.zeros(self.m)])
        t.llo, t.lhi = self._logical_bounds(srhs)
        if x_warm is not None:
            # the previous stage's optimum is feasible here (its objective
            # bound was fixed at the achieved value) -> warm incumbent.
            # A sweep-chain hint (LexRequest.x_hint) violates the NEW
            # objective bound by one front step — repair it first: unit
            # moves/swaps for inequality structures, 2x2 cycle moves for
            # the assignment family (where any single swap breaks two
            # equality rows).
            from moip_aira_tpu.solver.heuristics import (
                candidate_value, cycle_improve, repair,
            )

            glo = np.concatenate([self.problem.lb, t.llo])
            ghi = np.concatenate([self.problem.ub, t.lhi])
            struct = self._assign_struct(glo, ghi)
            v = candidate_value(self._A_full, t.c_struct, glo, ghi, x_warm)
            if v is None and self.int_idx.size:
                xr = None
                if struct is not None:
                    xr = cycle_improve(
                        self._A_full, t.c_struct, glo, ghi,
                        np.asarray(x_warm, dtype=np.float64), struct,
                    )
                if xr is None:
                    xr = repair(
                        self._A_full, t.c_struct, glo, ghi,
                        np.asarray(x_warm, dtype=np.float64), self.int_idx,
                    )
                if xr is not None:
                    x_warm = xr
                    v = candidate_value(
                        self._A_full, t.c_struct, glo, ghi, x_warm
                    )
            if v is not None:
                t.best = v
                t.best_x = np.asarray(x_warm, dtype=np.float64).copy()
        return t

    def _logical_bounds(self, srhs):
        p = self.problem
        if self.is_min:
            olo, ohi = np.full(self.k, -INF), srhs
        else:
            olo, ohi = srhs, np.full(self.k, INF)
        lo = np.concatenate([p.row_lb, olo])
        hi = np.concatenate([p.row_ub, ohi])
        return lo, hi

    def _certify_wave(self, c, lo, hi, status, basis, at_upper):
        """Certify f32 device claims in f64; uncertified lanes continue the
        exact host simplex *warm-started from the device basis* (usually a
        couple of pivots — the f32 kernel lands on or next to the optimal
        vertex; see solver/verify.py).

        Soundness model (see verify.py): pruning uses ONLY
        ``self._dual_lb`` — the rigorous interval dual bound where the
        certificate held, the exact host LP value where it did not.  The
        claimed vertex value ``objv`` guides heuristics and branching but
        never a prune."""
        cert = self._verifier.certify(c, lo, hi, status, basis, at_upper)
        self.cert_failures += int((~cert.ok).sum())
        objv = np.where(cert.ok, cert.obj, np.nan)
        xs = cert.x
        self._last_cert = cert
        # duals are only valid where the certificate held AND the device
        # claimed OPTIMAL (verify.py contract); uncertified lanes keep
        # *stale* cert rows — reduced-cost fixing on those is unsound
        # (can fix off the true optimum)
        self._cert_fix_ok = cert.ok & (status == sx.OPTIMAL)
        self._dual_lb = cert.dual_bound.copy()
        self._lane_exact = np.zeros(len(status), dtype=bool)
        # every uncertified or iteration-limited lane — and any certified
        # lane whose rigorous bound came out -inf — is re-solved exactly
        # NOW, warm-started from the device basis (measured ~2% of lanes,
        # caused by the kernel's loose f32 termination tolerances).  All
        # such lanes resolve in ONE batched lockstep f64 simplex call
        # (solver/simplex_batch.py) instead of sequential per-lane solves.
        retry = np.flatnonzero(
            ~cert.ok
            | ((status != sx.OPTIMAL) & (status != sx.INFEASIBLE))
            | ((status == sx.OPTIMAL) & ~np.isfinite(cert.dual_bound))
        )
        if retry.size:
            rs = self._host_exact_lp_batch(
                c[retry][:, : self.n], lo[retry], hi[retry],
                basis[retry], at_upper[retry],
            )
            for k_, i in enumerate(retry):
                r = rs[k_]
                self._lane_exact[i] = True
                self._cert_fix_ok[i] = False
                if r.status == SolveStatus.OPTIMAL:
                    status[i] = sx.OPTIMAL
                    objv[i] = r.obj
                    xs[i] = r.x
                    self._dual_lb[i] = r.obj
                elif r.status == SolveStatus.INFEASIBLE:
                    status[i] = sx.INFEASIBLE
                    objv[i] = np.nan
                    self._dual_lb[i] = np.inf
                else:
                    status[i] = sx.ITER_LIMIT
        return status, objv, xs

    def _host_exact_lp(self, c_struct, lo, hi, warm_basis, warm_at_upper):
        """One exact f64 LP on the host, warm-started from a device basis."""
        if self._ws is None:
            from moip_aira_tpu.solver.simplex_np import SimplexWorkspace

            self._ws = SimplexWorkspace(
                np.vstack([self.problem.A, self.problem.C])
            )
        from moip_aira_tpu.solver.simplex_np import solve_lp
        from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS

        self.verify_fallbacks += 1
        with GLOBAL_TIMINGS.span("host.exact_lp"):
            return solve_lp(
                self._ws, c_struct, lo, hi,
                warm_basis=warm_basis, warm_at_upper=warm_at_upper,
            )

    def _host_exact_lp_batch(self, cS, loS, hiS, wbS=None, waS=None):
        """Batched exact f64 LPs — ALL of a wave's failed lanes in one
        lockstep vectorised call (solver/simplex_batch.py) instead of one
        sequential `solve_lp` per lane."""
        if self._ws is None:
            from moip_aira_tpu.solver.simplex_np import SimplexWorkspace

            self._ws = SimplexWorkspace(
                np.vstack([self.problem.A, self.problem.C])
            )
        from moip_aira_tpu.solver.simplex_batch import solve_lp_batch
        from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS

        self.verify_fallbacks += len(cS)
        with GLOBAL_TIMINGS.span("host.exact_lp"):
            return solve_lp_batch(
                self._ws, np.asarray(cS, dtype=np.float64),
                np.asarray(loS, dtype=np.float64),
                np.asarray(hiS, dtype=np.float64),
                warm_basis=wbS, warm_at_upper=waS,
            )

    # -- wave submit / complete --------------------------------------------
    def _submit_wave(self, active: List[_StageTask]):
        """Gather open nodes from ``active`` and start an async device call.

        Returns (wave, buffers, device_out) or None if nothing is pending.
        The device call is NOT waited on — the caller can overlap host work
        (completing another pool's wave) with this one's device time.
        """
        B = self.batch_width
        nc = self.n + self.m
        wave: List = []  # (task, node_lo, node_hi, parent_bound)
        # adaptive quota: when few tasks are active (deep in the epsilon
        # ladder it's often 2-4), a fixed nodes_per_task leaves the wave
        # nearly empty — the device runs 16 of 256 lanes.  Let every task
        # claim an equal share of the whole batch instead; nodes_per_task
        # stays the floor so many-task phases keep their fair round-robin.
        n_active = sum(1 for t_ in active if t_.nodes)
        quota = max(self.nodes_per_task, B // max(1, n_active))
        for task in active:
            take = 0
            eps_t = INT_TOL if task.obj_int else 1e-9
            while take < quota and task.nodes and len(wave) < B:
                node = task.nodes.pop()
                if node[2] >= task.best - eps_t:
                    continue  # incumbent improved since this node was made
                wave.append((task, *node))
                take += 1
            task.inflight += take
            if len(wave) >= B:
                break
        nb = len(wave)
        if nb == 0:
            return None
        c_buf = np.zeros((B, nc))
        lo_buf = np.zeros((B, nc))
        hi_buf = np.zeros((B, nc))
        for i, (task, nlo, nhi, _pb) in enumerate(wave):
            c_buf[i] = task.cvec
            lo_buf[i, : self.n] = nlo
            lo_buf[i, self.n :] = task.llo
            hi_buf[i, : self.n] = nhi
            hi_buf[i, self.n :] = task.lhi
        # padding lanes stay the TRIVIAL LP (all columns fixed at 0, zero
        # cost): they go optimal on the first pricing pass, so they never
        # extend the batched while-loop, which runs to its slowest lane
        out = self._lp_batch(c_buf, lo_buf, hi_buf)
        return wave, nb, c_buf, lo_buf, hi_buf, out

    def _complete_wave(self, submitted) -> None:
        """Fetch, certify and branch-process one in-flight wave."""
        wave, nb, c_buf, lo_buf, hi_buf, out = submitted
        from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS

        with GLOBAL_TIMINGS.span("wave.device_lp"):
            status, objv, xs, basis_h, atup_h, iters = jax.device_get(
                (out.status, out.obj, out.x, out.basis, out.at_upper, out.iters)
            )
        status = np.asarray(status)
        objv = np.asarray(objv, dtype=np.float64)
        xs = np.asarray(xs, dtype=np.float64)
        self.device_waves += 1
        self.lp_count += nb
        self.wave_iters += int(iters.max())
        self.lane_iters += int(iters[:nb].sum())

        if self.f32:
            with GLOBAL_TIMINGS.span("wave.certify"):
                status, objv, xs = self._certify_wave(
                    np.array(c_buf[:nb]), np.array(lo_buf[:nb]),
                    np.array(hi_buf[:nb]),
                    np.array(status[:nb]), np.asarray(basis_h)[:nb],
                    np.asarray(atup_h)[:nb],
                )

        # ---- process on host (branch decisions vectorised) ----------
        if True:
            obj_int_arr = np.fromiter(
                (w[0].obj_int for w in wave), dtype=bool, count=nb
            )
            # node lower bounds: the rigorous interval dual bound for
            # certified f32 lanes, the host/device exact LP value otherwise
            # (verify.py soundness model — the claimed vertex value objv is
            # NEVER used to prune)
            if self.f32:
                lane_lb = self._dual_lb[:nb]
                lane_exact = self._lane_exact[:nb]
            else:
                lane_lb = objv[:nb]
                lane_exact = np.ones(nb, dtype=bool)
            bounds = np.where(
                obj_int_arr, np.ceil(lane_lb - INT_TOL), lane_lb
            )
            if self.int_idx.size:
                xi = xs[:nb][:, self.int_idx]
                frs = np.abs(xi - np.rint(xi))
                jmaxs = np.argmax(frs, axis=1)
                lanes = np.arange(nb)
                frmaxs = frs[lanes, jmaxs]
                jlocs = self.int_idx[jmaxs]
                fls = np.floor(xs[:nb][lanes, jlocs] + INT_TOL)
                # batched rounding heuristic: ONE feasibility GEMM for every
                # lane's rounded-and-clipped LP point (the per-lane
                # candidate_value calls were the dominant host cost)
                cands = xs[:nb].copy()
                r_lo = np.stack([w[1] for w in wave])
                r_hi = np.stack([w[2] for w in wave])
                ii = self.int_idx
                cands[:, ii] = np.clip(
                    np.rint(cands[:, ii]), r_lo[:, ii], r_hi[:, ii]
                )
                acts = cands @ self._A_full.T  # (nb, m)
                glo_l = np.stack([w[0].llo for w in wave])
                ghi_l = np.stack([w[0].lhi for w in wave])
                htol = 1e-7
                cand_ok = (
                    (cands >= self.problem.lb[None, :] - htol)
                    & (cands <= self.problem.ub[None, :] + htol)
                ).all(axis=1) & (
                    (acts >= glo_l - htol) & (acts <= ghi_l + htol)
                ).all(axis=1)
                c_structs = np.stack([w[0].c_struct for w in wave])
                cand_vals = np.where(
                    cand_ok, np.einsum("ln,ln->l", cands, c_structs), np.inf
                )
            else:
                frmaxs = np.zeros(nb)
                jlocs = np.zeros(nb, dtype=np.int64)
                fls = np.zeros(nb)
                cand_ok = np.zeros(nb, dtype=bool)
                cand_vals = np.full(nb, np.inf)
            for i, (task, nlo, nhi, _pb) in enumerate(wave):
                task.node_count += 1
                task.inflight -= 1
                if task.failed:
                    continue
                st = int(status[i])
                if st == sx.INFEASIBLE:
                    continue
                if st != sx.OPTIMAL or task.node_count > self.max_nodes:
                    # resource trouble — resolve this whole request on host
                    task.failed = True
                    task.nodes.clear()
                    continue
                eps_i = INT_TOL if task.obj_int else 1e-9
                if bounds[i] >= task.best - eps_i:
                    continue
                if frmaxs[i] <= INT_TOL:
                    # integral leaf.  For certified (non-exact) lanes the
                    # value objv is the claimed vertex's — validate the
                    # rounded candidate exactly in f64 before adopting, and
                    # close the node only if its rigorous bound proves no
                    # strictly better point exists in it; otherwise fall
                    # through to an exact host re-solve of the lane.
                    if lane_exact[i]:
                        if objv[i] < task.best - INT_TOL:
                            task.best = objv[i]
                            task.best_x = xs[i].copy()
                        continue
                    if cand_ok[i]:
                        v = cand_vals[i]
                        if v < task.best - INT_TOL:
                            task.best = v
                            task.best_x = cands[i].copy()
                        if bounds[i] >= v - eps_i:
                            continue  # node closed: nothing in it beats v
                    # validation failed or bound too weak to close the node:
                    # the exact host LP settles it
                    r = self._host_exact_lp(
                        c_buf[i, : self.n], lo_buf[i], hi_buf[i],
                        basis_h[i], atup_h[i],
                    )
                    self._cert_fix_ok[i] = False
                    if r.status == SolveStatus.INFEASIBLE:
                        continue
                    if r.status != SolveStatus.OPTIMAL:
                        task.failed = True
                        task.nodes.clear()
                        continue
                    objv[i] = r.obj
                    xs[i] = r.x
                    bounds[i] = (
                        np.ceil(r.obj - INT_TOL) if task.obj_int else r.obj
                    )
                    if bounds[i] >= task.best - eps_i:
                        continue
                    if self.int_idx.size:
                        xi_i = r.x[self.int_idx]
                        fr_i = np.abs(xi_i - np.rint(xi_i))
                        jm = int(np.argmax(fr_i))
                        frmaxs[i] = fr_i[jm]
                        jlocs[i] = self.int_idx[jm]
                        fls[i] = np.floor(r.x[jlocs[i]] + INT_TOL)
                    if frmaxs[i] <= INT_TOL:
                        # exact LP optimum is integral: node optimum found
                        if objv[i] < task.best - INT_TOL:
                            task.best = objv[i]
                            task.best_x = xs[i].copy()
                        continue
                    # else: fall through and branch on the exact solution

                # rounding + local-search heuristic (budgeted per MIP).
                # The rounded candidate is adopted whenever it improves the
                # incumbent (already validated in the batched pass above);
                # the 1-swap polish only runs when that adoption happened —
                # polishing non-improving candidates was measured as the
                # single largest host cost on small-instance workloads.
                if cand_ok[i] and self.int_idx.size:
                    v = cand_vals[i]
                    if v < task.best - INT_TOL:
                        task.best = v
                        task.best_x = cands[i].copy()
                        if task.ls_budget > 0:
                            from moip_aira_tpu.solver.heuristics import local_search

                            task.ls_budget -= 1
                            glo = np.concatenate([self.problem.lb, task.llo])
                            ghi = np.concatenate([self.problem.ub, task.lhi])
                            cand, v = local_search(
                                self._A_full, task.c_struct, glo, ghi,
                                cands[i].copy(), self.int_idx,
                            )
                            if v < task.best - INT_TOL:
                                task.best = v
                                task.best_x = cand.copy()
                        if bounds[i] >= task.best - (
                            INT_TOL if task.obj_int else 1e-9
                        ):
                            continue

                # reduced-cost fixing — rigorous version (verify.py model):
                # with y the certificate's dual vector, ANY feasible z with
                # integer z_j moved off its bound by >= 1 has
                #   c.z >= dual_lb + max(0, d_j -+ E_j)
                # so the fix is sound iff dual_lb + gain clears the cutoff.
                # Uses dual_lb (never objv) and the d +- d_err envelope;
                # only where _cert_fix_ok (dual_lb and d come from the SAME
                # y — host-resolved lanes have stale d rows).
                child_lo = nlo
                child_hi = nhi
                cert = getattr(self, "_last_cert", None)
                if (
                    task.fix_d
                    and cert is not None
                    and cert.d is not None
                    and cert.d_err is not None
                    and getattr(self, "_cert_fix_ok", None) is not None
                    and self._cert_fix_ok[i]
                    and np.isfinite(task.best)
                    and np.isfinite(lane_lb[i])
                ):
                    margin = (
                        task.best
                        - (1.0 if task.obj_int else 0.0)
                        - lane_lb[i]
                        + INT_TOL
                    )
                    if np.isfinite(margin):
                        dx = cert.d[i][self.int_idx]
                        ex = cert.d_err[i][self.int_idx]
                        nbm = ~cert.in_basis[i][self.int_idx]
                        upm = cert.at_upper[i][self.int_idx]
                        f_lo = nbm & ~upm & (dx - ex > margin)
                        f_hi = nbm & upm & (-dx - ex > margin)
                        if f_lo.any() or f_hi.any():
                            child_lo = nlo.copy()
                            child_hi = nhi.copy()
                            ids_lo = self.int_idx[f_lo]
                            ids_hi = self.int_idx[f_hi]
                            child_hi[ids_lo] = nlo[ids_lo]
                            child_lo[ids_hi] = nhi[ids_hi]

                jloc = int(jlocs[i])
                fl = fls[i]
                up_lo = child_lo.copy()
                up_lo[jloc] = fl + 1
                dn_hi = child_hi.copy()
                dn_hi[jloc] = fl
                # DFS toward the LP value: nearer child on top; children
                # inherit this node's certified bound for submit-time pruning
                pb = float(bounds[i])
                if xs[i][jloc] - fl > 0.5:
                    task.nodes.append((child_lo, dn_hi, pb))
                    task.nodes.append((up_lo, child_hi, pb))
                else:
                    task.nodes.append((up_lo, child_hi, pb))
                    task.nodes.append((child_lo, dn_hi, pb))

    def _advance_pool(
        self, pool: List[_StageTask], state, feeder=None
    ) -> List[_StageTask]:
        """Finish tasks whose stacks drained; start their next stages.

        ``feeder(req_idx, outcome) -> List[LexRequest]`` streams NEW
        requests in as others complete (no batch barrier): the returned
        requests join the pool immediately, so adaptive drivers (the bound
        sweep) keep the device saturated instead of idling on stragglers.
        """
        reqs, results, ips, infeasible, srhs_by_req, perms, xwarm_by_req = state
        import os as _os

        audit = _os.environ.get("MOIP_WAVE_LOG")
        still: List[_StageTask] = []

        def _request_done(ri: int) -> None:
            if feeder is None:
                return
            if infeasible[ri]:
                out = LexOutcome(SolveStatus.INFEASIBLE, None, int(ips[ri]))
            else:
                out = LexOutcome(
                    SolveStatus.OPTIMAL, results[ri].copy(), int(ips[ri]),
                    x=xwarm_by_req[ri],
                )
            for nr in feeder(ri, out) or ():
                nj = len(reqs)
                reqs.append(nr)
                results.append(np.zeros(self.k, dtype=np.int64))
                ips.append(0)
                infeasible.append(False)
                srhs_by_req.append(np.asarray(nr.rhs, dtype=np.float64).copy())
                perms.append(list(nr.perm))
                xwarm_by_req.append(None)
                still.append(
                    self._stage_task(
                        nj, 0, perms[nj], srhs_by_req[nj],
                        x_warm=getattr(nr, "x_hint", None),
                    )
                )

        for task in pool:
            if (task.nodes and not task.failed) or task.inflight > 0:
                still.append(task)
                continue
            ri = task.req_idx
            ips[ri] += 1
            if audit:
                with open(audit, "a") as fh:
                    fh.write(
                        f'{{"rhs": {list(map(float, srhs_by_req[ri]))}, '
                        f'"perm": {perms[ri]}, "stage": {task.stage}, '
                        f'"obj_j": {task.obj_j}, '
                        f'"failed": {str(task.failed).lower()}, '
                        f'"best": {float(task.best)}, '
                        f'"nodes": {task.node_count}}}\n'
                    )
            if task.failed:
                # exact host fallback for the whole request
                from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS

                self.req_fallbacks += 1
                with GLOBAL_TIMINGS.span("host.req_fallback"):
                    fb = self._fallback.lex_solve(reqs[ri])
                infeasible[ri] = fb.status.is_infeasible
                if fb.result is not None:
                    results[ri] = np.asarray(fb.result, dtype=np.int64)
                _request_done(ri)
                continue
            if not np.isfinite(task.best):
                infeasible[ri] = True
                _request_done(ri)
                continue
            val = task.best if self.is_min else -task.best
            vi = int(np.rint(val))
            results[ri][task.obj_j] = vi
            srhs_by_req[ri][task.obj_j] = float(vi)
            xwarm_by_req[ri] = task.best_x
            nxt = task.stage + 1
            if nxt < self.k:
                still.append(
                    self._stage_task(
                        ri, nxt, perms[ri], srhs_by_req[ri],
                        x_warm=xwarm_by_req[ri],
                    )
                )
            else:
                _request_done(ri)
        return still

    # -- main entry --------------------------------------------------------
    #: adaptive drivers may stream requests in via lex_solve_batch(feeder=)
    supports_feeder = True

    def lex_solve_batch(
        self, reqs: List[LexRequest], feeder=None
    ) -> List[LexOutcome]:
        """Run all requests to completion with TWO pipelined task pools:
        while the device solves pool A's LP wave, the host certifies,
        branches and re-submits pool B's — hiding the dispatch round-trip
        and the host bookkeeping behind device time.

        ``feeder``: see _advance_pool — completed requests can stream new
        ones into the pool, barrier-free."""
        if not reqs:
            return []
        reqs = list(reqs)
        n0 = len(reqs)
        results = [np.zeros(self.k, dtype=np.int64) for _ in range(n0)]
        ips = [0] * n0
        infeasible = [False] * n0
        srhs_by_req = [np.asarray(r.rhs, dtype=np.float64).copy() for r in reqs]
        perms = [list(r.perm) for r in reqs]
        xwarm_by_req = [None] * n0
        self._last_cert = None
        state = (reqs, results, ips, infeasible, srhs_by_req, perms, xwarm_by_req)

        pool = [
            self._stage_task(
                i, 0, perms[i], srhs_by_req[i],
                x_warm=getattr(reqs[i], "x_hint", None),
            )
            for i in range(n0)
        ]
        from collections import deque

        inflight = deque()
        B = self.batch_width
        while pool or inflight:
            # keep up to 2 waves in flight: the device solves one while the
            # host certifies/branches the other. A second wave is only worth
            # its dispatch cost when it can be reasonably full.
            while len(inflight) < 2:
                if inflight:
                    pending = sum(len(t.nodes) for t in pool)
                    if pending < B // 2:
                        break
                sub = self._submit_wave(pool)
                if sub is None:
                    break
                inflight.append(sub)
            if inflight:
                self._complete_wave(inflight.popleft())
                pool = self._advance_pool(pool, state, feeder)
            else:
                # nothing submittable and nothing pending — but submit-time
                # pruning may have just emptied stacks, leaving finished
                # tasks to advance (and possibly next stages to start)
                drained = self._advance_pool(pool, state, feeder)
                if len(drained) == len(pool) and not any(
                    t.nodes for t in drained
                ):
                    pool = drained
                    break
                pool = drained

        out: List[LexOutcome] = []
        for i in range(len(reqs)):
            if infeasible[i]:
                out.append(LexOutcome(SolveStatus.INFEASIBLE, None, int(ips[i])))
            else:
                out.append(
                    LexOutcome(
                        SolveStatus.OPTIMAL, results[i].copy(), int(ips[i]),
                        x=xwarm_by_req[i],
                    )
                )
        return out
