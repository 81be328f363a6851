"""High-level front computation — the programmatic equivalent of the
reference's ``main`` (src/aira.cpp:140-364) minus file I/O."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from moip_aira_tpu.core.store import Solutions
from moip_aira_tpu.native import make_solutions
from moip_aira_tpu.engine.scheduler import Scheduler
from moip_aira_tpu.engine.worker_spec import WorkerSpec
from moip_aira_tpu.parallel.cluster import build_cluster
from moip_aira_tpu.parallel.split import (
    MAX_WORKERS_NORMAL_SPLIT,
    split_setup,
)
from moip_aira_tpu.parallel.symgroup import max_workers
from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense
from moip_aira_tpu.utils.device import enable_compile_cache, platform


@dataclasses.dataclass
class FrontResult:
    #: nondominated points, sorted descending, deduplicated — shape (f, k)
    points: np.ndarray
    ip_count: int
    cpu_seconds: float
    elapsed_seconds: float
    rounds: int = 0
    batch_sizes: Optional[List[int]] = None
    #: mesh runs only: per-domain IP counts + shared pre-work IPs — on real
    #: multi-chip hardware wall time tracks pre_ips + max(domain_ips)
    domain_ips: Optional[List[int]] = None
    pre_ips: int = 0

    @property
    def solution_count(self) -> int:
        return int(self.points.shape[0])


def make_backend(
    problem: Problem,
    backend: str = "auto",
    mesh_devices=None,
    solver_threads: int = 1,
):
    """``solver_threads`` mirrors the reference's `-c` knob (CPLEX-internal
    threads per worker, aira.cpp:236-239): here it scales the number of
    branch-and-bound nodes each MIP contributes to a device wave.

    ``backend`` may also be an already-constructed backend instance
    (anything with ``lex_solve_batch``) — used by tests and power users to
    pass non-default backend knobs (e.g. WaveLexBackend(batch_width=8))."""
    if not isinstance(backend, str):
        return backend
    enable_compile_cache()
    mesh = None
    if mesh_devices:
        from moip_aira_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(mesh_devices)
    npt = max(8, 8 * max(1, solver_threads))
    if backend == "numpy":
        from moip_aira_tpu.solver.lex import NumpyLexBackend

        return NumpyLexBackend(problem)
    if backend == "wave":
        from moip_aira_tpu.solver.wave import WaveLexBackend

        return WaveLexBackend(problem, mesh=mesh, nodes_per_task=npt)
    if backend == "jax":
        from moip_aira_tpu.solver.lex_jax import JaxLexBackend

        return JaxLexBackend(problem)
    if backend == "kpbb":
        from moip_aira_tpu.solver.kp_bb import KnapsackLexBackend

        return KnapsackLexBackend(problem)
    if backend == "apbb":
        from moip_aira_tpu.solver.ap_bb import APLexBackend

        return APLexBackend(problem)
    if backend == "auto":
        # structure-aware routing first: the multi-constraint knapsack
        # family closes its IPs with exact surrogate-DP combinatorics
        # (solver/kp_bb.py), which the LP-relaxation path's tiny knapsack
        # gaps cannot match
        from moip_aira_tpu.solver.kp_bb import (
            KnapsackLexBackend,
            detect_kp_family,
        )

        fam = detect_kp_family(problem)
        if fam is not None:
            return KnapsackLexBackend(problem, fam)
        # assignment family: Lagrangian matching branch-and-bound
        # (solver/ap_bb.py) closes each lex IP with exact integer Hungarian
        # bounds instead of degenerate Birkhoff-polytope LPs
        from moip_aira_tpu.solver.ap_bb import APLexBackend, detect_ap_family

        afam = detect_ap_family(problem)
        if afam is not None:
            return APLexBackend(problem, afam)
        if platform() == "cpu":
            # monolithic on-device kernel: compiles fast under XLA:CPU
            from moip_aira_tpu.solver.lex_jax import JaxLexBackend

            return JaxLexBackend(problem)
        # GPU: host-driven B&B over the batched f32 LP kernel, every lane
        # certified in f64
        from moip_aira_tpu.solver.wave import WaveLexBackend

        return WaveLexBackend(problem, mesh=mesh, nodes_per_task=npt)
    raise ValueError(f"unknown backend {backend!r}")


def solve_front(
    problem: Problem,
    n_workers: int = 1,
    spread: bool = True,
    split: bool = False,
    split_normal: bool = False,
    backend: str = "auto",
    mesh_devices=None,
    solver_threads: int = 1,
    dp: str = "auto",
    sweep: str = "auto",
) -> FrontResult:
    """Compute the exact nondominated set of ``problem``.

    Mirrors the reference driver: the synergistic cluster decomposition by
    default (aira.cpp:277-308), or the EPP range split with ``split=True``
    (aira.cpp:269-276).

    ``dp``: 'auto' routes single-capacity bi-objective knapsack instances
    to the full-front dynamic program (solver/kp_front.py) — the whole
    nondominated set in one dense device DP, no MIP ladder; 'off' forces
    the general AIRA engine; 'on' forces the DP attempt even when the
    ``MOIP_DP`` environment override (used by the test suite to pin the
    AIRA path) says otherwise.  The front is identical either way (the DP
    is exact); the decomposition flags only affect how the AIRA engine
    would have parallelised, so they are validated but otherwise moot.
    """
    t_cpu0 = time.process_time()
    t_wall0 = time.monotonic()
    n_workers = max(1, n_workers)

    if split and split_normal and n_workers > MAX_WORKERS_NORMAL_SPLIT:
        raise ValueError(
            f"split_normal supports at most {MAX_WORKERS_NORMAL_SPLIT} workers"
        )

    if dp == "auto":
        dp = os.environ.get("MOIP_DP", "auto")
    # instances with n < 80 skip the device DP and go to the general
    # engine (kp_bb for the knapsack family); dp='on' still forces the DP
    # attempt.  The cutoff was set against a slow device link; on the H100
    # the DP is the faster engine from n=50 on (PERF.md), so the cutoff is
    # open work (ROADMAP S6), kept here so routing does not change.
    if dp == "on" or (dp != "off" and problem.n >= 80):
        from moip_aira_tpu.solver.kp_front import kp2_front

        pts = kp2_front(problem)
        if pts is not None:
            return FrontResult(
                points=pts,
                ip_count=0,
                cpu_seconds=time.process_time() - t_cpu0,
                elapsed_seconds=time.monotonic() - t_wall0,
            )

    be = make_backend(
        problem, backend, mesh_devices=mesh_devices,
        solver_threads=solver_threads,
    )

    # ``sweep``: the adaptive parallel bound sweep (solver/sweep.py) — the
    # batch-shaped k=2 front driver.  The AIRA epsilon ladder is one DEPENDENT
    # lex-IP per front point, so device batches from 1-2 workers run nearly
    # empty; the sweep solves a whole grid of objective-bound subproblems
    # per round (exact; same lex backend) and converges in ~front/batch
    # adaptive rounds.  'auto' uses it for bi-objective problems on the
    # batch-parallel backends (wave / jax); 'off' forces the ladder (the
    # reference-parity engine); MOIP_SWEEP overrides 'auto'.  Under a mesh
    # the MeshScheduler owns the multi-chip enumeration, and under --split
    # the EPP strips are the requested decomposition — both keep the ladder.
    if sweep == "auto":
        sweep = os.environ.get("MOIP_SWEEP", "auto")
    use_sweep = (
        sweep != "off"
        and problem.objcnt == 2
        and not split
        and not mesh_devices
        and getattr(be, "name", "") in ("wave", "jax")
    ) or sweep == "on"
    if use_sweep:
        from moip_aira_tpu.solver.sweep import sweep_front

        sw = sweep_front(
            problem, be, batch=getattr(be, "batch_width", 64)
        )
        if sw is not None:
            return FrontResult(
                points=sw.points,
                ip_count=sw.ip_count,
                cpu_seconds=time.process_time() - t_cpu0,
                elapsed_seconds=time.monotonic() - t_wall0,
                rounds=sw.rounds,
                batch_sizes=sw.batch_sizes,
            )

    sched = Scheduler(problem, be)
    k = problem.objcnt
    all_store = make_solutions(k)
    infeasibles = make_solutions(k)

    if mesh_devices and not split:
        # distributed enumeration: workers partitioned into per-device
        # domains, cross-domain pruning through the mesh collective
        # (engine/mesh_scheduler.py); the wave backend above additionally
        # shards its LP waves over the same mesh
        from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler
        from moip_aira_tpu.parallel.mesh import make_mesh

        mesh_mode = os.environ.get("MOIP_MESH_MODE", "strip")
        if mesh_mode == "sync":
            # synergistic workers cap at the ordering-subgroup count;
            # EPP strips (the default) have no such ceiling
            n_workers = min(n_workers, max_workers(k))
        msched = MeshScheduler(
            problem, be,
            getattr(be, "mesh", None) or make_mesh(mesh_devices),
            mode=mesh_mode,
        )
        msched.run(n_workers, spread, all_store)
        points = all_store.sorted_unique_points()
        return FrontResult(
            points=points,
            ip_count=msched.ip_count,
            cpu_seconds=time.process_time() - t_cpu0,
            elapsed_seconds=time.monotonic() - t_wall0,
            rounds=msched.rounds,
            batch_sizes=msched.batch_sizes,
            domain_ips=list(msched.domain_ips),
            pre_ips=msched.pre_ips,
        )

    if split:
        pts = split_setup(sched, k, n_workers, split_normal, infeasibles)
        # seed ip such that it can never answer a relaxation query
        # (reference main inserts these with an uninitialised ip vector,
        # aira.cpp:271-276 — see SURVEY §2/C11)
        dead_ip = np.full(k, -INF if problem.objsen is Sense.MIN else INF)
        for p_ in pts:
            all_store.insert(dead_ip, p_, False)
    else:
        n_workers = min(n_workers, max_workers(k))
        specs = build_cluster(n_workers, k, problem.objsen, spread)
        sched.run(specs, all_store, infeasibles)

    points = all_store.sorted_unique_points()
    return FrontResult(
        points=points,
        ip_count=sched.ip_count,
        cpu_seconds=time.process_time() - t_cpu0,
        elapsed_seconds=time.monotonic() - t_wall0,
        rounds=sched.rounds,
        batch_sizes=sched.batch_sizes,
    )
