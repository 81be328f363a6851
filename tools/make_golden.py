"""Generate a bundled golden front, with independent oracle spot-checks.

Offline tool; run it with JAX_PLATFORMS=cpu unless ``--engine wave`` should
use the GPU.  Generates
the named instance with the same seed policy as bench_scale.py (seed=1),
bundles it under examples/, solves it with the chosen engine, and writes
the golden ``examples/<name>.out`` through the byte-compatible writer.

Engines:
  numpy — the exact-f64 host oracle (CLAUDE.md ground truth); slowest,
          needs no further verification, but ~8,000 s at KP2D100 scale
          and unusable beyond it (measured round 4).
  kpbb  — the combinatorial knapsack engine (solver/kp_bb.py): exact
          int64 arithmetic end to end, ~1000x the oracle's speed on the
          KP2D family.
  apbb  — the combinatorial assignment engine (solver/ap_bb.py): exact
          integer Hungarian bounds, ~100x the oracle on the AP family.
  wave  — the GPU wave path (every emitted point f64-certified per
          the exactness invariant).
  auto  — whatever api.solve_front routes to.

``--verify-sample K`` (bi-objective instances) independently re-derives a
random K-point sample of the generated front — plus both lex extremes —
with the NUMPY ORACLE, three checks per sampled point i (front sorted
descending obj0; b ascending):
  * own-box lex(0,1) at rhs[1]=b_i must return exactly point i,
  * own-box lex(1,0) at rhs[0]=a_i must return exactly point i,
  * the ADJACENT GAP: lex(0,1) at rhs[1]=b_i -/+ 1 (MIN/MAX) must return
    exactly the neighbouring point (or INFEASIBLE at the extreme), which
    proves no nondominated point is missing between the two.
The record lands in examples/<name>.verify.json next to the golden, so a
fast-engine golden is never silently trusted.

Usage:
    python tools/make_golden.py KP2D200 --engine kpbb --verify-sample 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class _PointTimeout(Exception):
    pass


def verify_sample(
    p, points, k_sample: int, seed: int = 0, point_budget: int = 300
) -> dict:
    """Oracle spot-check of a bi-objective front; returns the record.

    ``k_sample=0`` checks the two lex extremes only (their own-box and
    adjacent-gap solves are the cheap ones — mid-front binding boxes can
    cost the LP-based oracle unbounded MIP time at ladder sizes).  Each
    point's three solves run under ``point_budget`` wall seconds
    (SIGALRM); a point that blows it is recorded as an oracle DNF, same
    as one that exhausts the oracle's MIP node budget.
    """
    import numpy as np

    from moip_aira_tpu.sense import Sense
    from moip_aira_tpu.solver.lex import LexRequest, NumpyLexBackend
    from moip_aira_tpu.solver.status import SolveStatus

    assert p.objcnt == 2, "sampled verification is bi-objective only"
    be = NumpyLexBackend(p)
    f = points.shape[0]
    rng = np.random.default_rng(seed)
    idx = sorted(
        {0, f - 1}
        | set(int(i) for i in rng.choice(f, size=min(k_sample, f), replace=False))
    )
    sign = -1 if p.objsen is Sense.MIN else 1  # gap step direction on b
    checks = []
    dnf = []
    t0 = time.monotonic()
    import signal

    def _alarm(_s, _f):
        raise _PointTimeout(f"point budget {point_budget}s")

    for i in idx:
        a_i, b_i = int(points[i][0]), int(points[i][1])
        rec = {"i": i, "point": [a_i, b_i]}
        signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(point_budget)
        try:
            checks.append(_verify_point(p, be, points, i, a_i, b_i, sign, rec))
        except (RuntimeError, _PointTimeout) as e:
            # the LP-based oracle hit its MIP resource limit on this box
            # (far-end knapsack IPs are exactly what it cannot do — the
            # reason the combinatorial engines exist).  Record the DNF
            # honestly; the verification verdict covers the points the
            # oracle COULD do, and the record names the ones it couldn't.
            rec["oracle_dnf"] = str(e)
            dnf.append(i)
            checks.append(rec)
            print(f"[verify] point {i} {[a_i, b_i]}: ORACLE DNF", flush=True)
        finally:
            signal.alarm(0)
    bools = [
        v for rec in checks for k, v in rec.items() if isinstance(v, bool)
    ]
    # a run where EVERY point DNF'd completed zero checks — that is not a
    # pass, it is no verification at all; require at least one
    all_ok = bool(bools) and all(bools)
    return {
        "sampled": idx,
        "front_size": int(f),
        "all_ok": bool(all_ok),
        "checks_completed": len(bools),
        "oracle_dnf_points": dnf,
        "oracle_seconds": round(time.monotonic() - t0, 1),
        "checks": checks,
    }


def _verify_point(p, be, points, i, a_i, b_i, sign, rec) -> dict:
    from moip_aira_tpu.sense import Sense
    from moip_aira_tpu.solver.lex import LexRequest
    from moip_aira_tpu.solver.status import SolveStatus

    f = points.shape[0]
    rhs = p.initial_rhs()
    rhs[1] = float(b_i)
    out = be.lex_solve(LexRequest(rhs=rhs, perm=[0, 1]))
    rec["own_box_01"] = bool(
        out.status == SolveStatus.OPTIMAL
        and out.result is not None
        and out.result[0] == a_i and out.result[1] == b_i
    )
    rhs = p.initial_rhs()
    rhs[0] = float(a_i)
    out = be.lex_solve(LexRequest(rhs=rhs, perm=[1, 0]))
    rec["own_box_10"] = bool(
        out.status == SolveStatus.OPTIMAL
        and out.result is not None
        and out.result[0] == a_i and out.result[1] == b_i
    )
    # adjacency gap: one step past b_i must land exactly on the
    # neighbour (or prove the box empty at the extreme)
    rhs = p.initial_rhs()
    rhs[1] = float(b_i + sign)
    out = be.lex_solve(LexRequest(rhs=rhs, perm=[0, 1]))
    j = i - 1 if p.objsen is Sense.MIN else i + 1
    if 0 <= j < f:
        rec["gap_to_neighbour"] = bool(
            out.status == SolveStatus.OPTIMAL
            and out.result is not None
            and out.result[0] == int(points[j][0])
            and out.result[1] == int(points[j][1])
        )
    else:
        rec["gap_to_neighbour"] = bool(out.status.is_infeasible)
    ok = all(v for k, v in rec.items() if isinstance(v, bool))
    print(f"[verify] point {i} {[a_i, b_i]}: "
          f"{'OK' if ok else 'FAILED ' + str(rec)}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--engine", default="numpy",
                    choices=("numpy", "kpbb", "apbb", "wave", "auto"))
    ap.add_argument("--verify-sample", type=int, default=-1, metavar="K",
                    help="oracle-verify K random points + both extremes "
                    "(K=0: extremes only; bi-objective only); record to "
                    "examples/<name>.verify.json")
    ap.add_argument("--verify-point-budget", type=int, default=300,
                    metavar="S", help="wall-second cap per verified point "
                    "(blown = recorded oracle DNF, not a crash)")
    ap.add_argument("--no-bundle-lp", action="store_true")
    args = ap.parse_args()

    from bench_scale import instance_path

    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.io.writer import write_out

    lp = instance_path(args.name)
    bundled_lp = os.path.join(REPO, "examples", f"{args.name}.lp")
    if not args.no_bundle_lp and os.path.abspath(lp) != os.path.abspath(bundled_lp):
        with open(lp) as src, open(bundled_lp, "w") as dst:
            dst.write(src.read())
        lp = bundled_lp

    p = read_problem(lp)
    print(f"[make_golden] {args.name}: n={p.n} rows={p.A.shape[0]} "
          f"objcnt={p.objcnt} engine={args.engine}", flush=True)
    t0 = time.monotonic()
    res = solve_front(p, n_workers=args.workers, backend=args.engine)
    dt = time.monotonic() - t0
    from moip_aira_tpu import __version__

    tag = {
        "numpy": "numpy oracle",
        "kpbb": "combinatorial knapsack engine",
        "apbb": "combinatorial assignment engine",
        "wave": "wave engine (f64-certified)",
        "auto": "auto engine",
    }[args.engine]
    out = os.path.join(REPO, "examples", f"{args.name}.out")
    with open(out, "w") as fh:
        write_out(fh, res, f"moip-aira-tpu {__version__} ({tag})")
    print(f"[make_golden] {args.name}: {res.solution_count} points, "
          f"{res.ip_count} IPs, {dt:.1f}s -> {out}", flush=True)

    if args.verify_sample >= 0:
        rec = verify_sample(p, res.points, args.verify_sample,
                            point_budget=args.verify_point_budget)
        rec["engine"] = args.engine
        rec["generated_seconds"] = round(dt, 1)
        rec["date"] = time.strftime("%Y-%m-%d")
        vpath = os.path.join(REPO, "examples", f"{args.name}.verify.json")
        with open(vpath, "w") as fh:
            json.dump(rec, fh, indent=1)
        ndnf = len(rec.get("oracle_dnf_points", []))
        print(f"[make_golden] verification {'PASSED' if rec['all_ok'] else 'FAILED'}"
              f" ({len(rec['checks'])} sampled points"
              + (f", {ndnf} oracle DNF" if ndnf else "")
              + f", {rec['oracle_seconds']}s oracle) -> {vpath}", flush=True)
        if not rec["all_ok"]:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
