"""Benchmark: lexicographic ILP subproblem throughput on one GPU, with a
front-parity guard.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "detail": {...}}

Workload: 1,920 distinct CLMOIP subproblems from the G2AP05 enumeration
space (both objective orderings x a grid of objective-bound boxes whose
ranges come from the instance's golden front), solved through the wave
backend: batched f32 device LPs + f64 certification + host B&B.  The value
is lexicographic ILP subproblems (CPXmipopt-equivalents) per second.

Baseline: the reference solves its 2AP05 at 24 IPs in 0.031 CPU-seconds
(Examples/2AP05.out footer; BASELINE.md §A) => ~774 IP/s on its
(unspecified) CPU.  vs_baseline = ours / 774.

Needs a GPU: with no GPU it exits non-zero and prints no result.

    python bench.py
"""

import json
import os
import subprocess
import sys
import time

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")

BASELINE_IPS_PER_SEC = 24 / 0.031  # reference 2AP05 footer


def read_front(path: str):
    """The Pareto front of a ``.out`` file as an (f, k) int64 array."""
    import numpy as np

    rows = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if parts and all(t.lstrip("-").isdigit() for t in parts):
                rows.append([int(t) for t in parts])
    return np.asarray(rows, dtype=np.int64)


def grid_requests(front, n_requests: int = 1920):
    """The bench grid over a bi-objective MIN front: both orderings x 32
    objective-1 bounds starting at the front's least objective-1 value x
    (no cap + 4 objective-0 caps spread over the front's objective-0
    range), then the same grid with every finite bound raised by 1..5, cut
    to ``n_requests``."""
    import numpy as np

    from moip_aira_tpu.solver.lex import LexRequest

    lo0, hi0 = int(front[:, 0].min()), int(front[:, 0].max())
    lo1 = int(front[:, 1].min())
    caps = [np.inf] + [float(round(v)) for v in np.linspace(hi0, lo0, 5)[:4]]
    reqs = []
    for perm in ([0, 1], [1, 0]):
        for b1 in range(lo1, lo1 + 32):
            for b0 in caps:
                rhs = np.array([float(b0), float(b1)])
                if perm == [1, 0]:
                    rhs = rhs[::-1]
                reqs.append(LexRequest(rhs=rhs, perm=perm))
    extra = []
    for r in reqs:
        for d in (1, 2, 3, 4, 5):
            rhs = r.rhs.copy()
            rhs[np.isfinite(rhs)] += d
            extra.append(LexRequest(rhs=rhs, perm=r.perm))
    return (reqs + extra)[:n_requests]


def gpu_info() -> dict:
    """Platform, kind and count as JAX reports them, plus the card's name
    and power limit from nvidia-smi.  Raises if JAX's device is no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's device platform is {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": smi,
    }


def main() -> int:
    device = gpu_info()

    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.solver.wave import WaveLexBackend

    p = read_problem(os.path.join(EXAMPLES, "G2AP05.lp"))
    golden = read_front(os.path.join(EXAMPLES, "G2AP05.out"))
    # 2048 lanes fit the whole 1920-request grid in one wave per stage
    # generation
    be = WaveLexBackend(p, batch_width=2048, nodes_per_task=32)
    reqs = grid_requests(golden)

    # --- warm-up (compile; persistent-cached across runs) ------------------
    t0 = time.perf_counter()
    be.lex_solve_batch(reqs[:2])
    warm_s = time.perf_counter() - t0

    # --- timed runs: median of 3 -------------------------------------------
    lp0, wv0 = int(be.lp_count), int(be.device_waves)
    trials = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = be.lex_solve_batch(reqs)
        dt = time.perf_counter() - t0
        trials.append((sum(o.ip_solves for o in outs) / dt, dt))
    trials.sort()
    ips_per_sec, dt = trials[1]

    # --- parity guard: the full enumeration must reproduce the golden front
    from moip_aira_tpu.api import solve_front

    front = solve_front(p, n_workers=2, backend=be, sweep="off")
    if not (front.points.shape == golden.shape and (front.points == golden).all()):
        raise AssertionError("G2AP05 front differs from examples/G2AP05.out")

    print(
        json.dumps(
            {
                "metric": "ilp_subproblems_per_sec",
                "value": ips_per_sec,
                "unit": "lex-IP/s",
                "vs_baseline": ips_per_sec / BASELINE_IPS_PER_SEC,
                "device": device,
                "detail": {
                    "workload": "G2AP05 subproblem grid x both orderings",
                    "requests": len(reqs),
                    "stage_ips": sum(o.ip_solves for o in outs),
                    "lp_relaxations": (int(be.lp_count) - lp0) // 3,
                    "device_waves": (int(be.device_waves) - wv0) // 3,
                    "verify_fallbacks": int(be.verify_fallbacks),
                    "seconds": dt,
                    "trials_ips_per_sec": [t[0] for t in trials],
                    "warmup_compile_seconds": warm_s,
                    "front_parity_G2AP05": True,
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
