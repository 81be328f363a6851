"""cProfile one warm solve through the wave backend.

Usage:
    python tools/profile_solve.py 2AP20 [--top 40] [--dump prof.out]

Runs one warm-up solve (compile + caches), then profiles a second solve
and prints the top functions by cumulative and by self time; ``--dump``
also writes the raw profile.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()

    from bench_scale import instance_path

    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.solver.wave import WaveLexBackend

    p = read_problem(instance_path(args.name))
    be = WaveLexBackend(p)
    t0 = time.monotonic()
    solve_front(p, backend=be)
    print(f"[profile] warmup {time.monotonic() - t0:.1f}s", flush=True)

    prof = cProfile.Profile()
    t0 = time.monotonic()
    prof.enable()
    res = solve_front(p, backend=be)
    prof.disable()
    dt = time.monotonic() - t0
    print(f"[profile] timed {dt:.1f}s, {res.solution_count} points", flush=True)
    if args.dump:
        prof.dump_stats(args.dump)
    st = pstats.Stats(prof)
    st.sort_stats("cumulative")
    print("==== by cumulative ====")
    st.print_stats(args.top)
    st.sort_stats("tottime")
    print("==== by self time ====")
    st.print_stats(args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
