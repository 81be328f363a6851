"""End-to-end smoke test of the exact-front solver on NVIDIA GPUs.

    python chip_smoke.py             # phases A-D on one card
    python chip_smoke.py --chips 4   # phase A, then phase E only (the mesh)

Runs in ONE process (a JAX process reserves most of a card's memory, so a
second one would fail); the CLI is driven in-process through
``moip_aira_tpu.cli.main``.  Phases:

  A  device    JAX's devices must be GPUs, else exit non-zero at once.
  B  DP        2KP100 through the CLI (front == examples/2KP100.out); the
               device DP against the NumPy DP at a table near the oracle's
               budget (exactly equal); DP vs kp_bb times on G2KP50/2KP100.
  C  LP waves  the 1,920-request bench grid on WaveLexBackend(2048) vs
               NumpyLexBackend; 256 random boxes over 2AP40's matrix,
               float32 device simplex vs float64 host simplex; the CLI on
               the .mop instance (auto route) and on G3AP05/G3KP10
               (--backend wave -t 2); 2AP20's full front on the wave
               backend.
  D  jax       the monolithic f64 kernel (--backend jax) on G2AP05, G3KP10.
  E  mesh      (--chips 4 only) G3AP05 with 6 workers over a 4-device mesh
               and on one device; both fronts golden; the devices that
               hold one wave's batch.

Each phase prints one JSON line; any failure raises (non-zero exit, no
result line).  Last line: {"ok": true, "device": {...}}.  Per-phase
records and the CLI's .out files also go to chiprun_out/smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from bench import grid_requests, gpu_info, read_front
from moip_aira_tpu import cli
from moip_aira_tpu.api import make_backend, solve_front
from moip_aira_tpu.io import read_problem
from moip_aira_tpu.utils.device import enable_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(REPO, "examples")
OUT_DIR = os.path.join(REPO, "chiprun_out", "smoke")

#: published device-memory bandwidth by JAX device_kind (NVIDIA data
#: sheets: H100 SXM5 80 GB HBM3 3.35 TB/s, H100 PCIe 80 GB HBM2e 2.0 TB/s)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}

#: LP lanes: float32 objective against float64, relative to max(1, |z|) —
#: the accumulation noise the wave backend's f32 tolerances assume
LP_OBJ_RTOL = 1e-3

_RECORDS: list = []


def emit(phase: str, **rec) -> dict:
    rec = {"phase": phase, **rec}
    _RECORDS.append(rec)
    print(json.dumps(rec, default=float), flush=True)
    return rec


def ex(name: str) -> str:
    return os.path.join(EXAMPLES, name)


def out_path(name: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.join(OUT_DIR, name)


def check_front(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if not (got.shape == want.shape and (got == want).all()):
        raise AssertionError(
            f"{name}: front differs from its golden "
            f"({got.shape[0]} points vs {want.shape[0]})"
        )


def run_cli(name: str, argv: list) -> dict:
    """``cli.main`` on examples/<name>; the written front must equal the
    golden ``examples/<stem>.out``."""
    stem = os.path.splitext(name)[0]
    out = out_path(f"{stem}{'_' + argv[1] if argv else ''}.out")
    t0 = time.perf_counter()
    rc = cli.main(["-p", ex(name), "-o", out, *argv])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main on {name} returned {rc}")
    got = read_front(out)
    check_front(name, got, read_front(ex(f"{stem}.out")))
    with open(out) as fh:
        ips = int(next(ln for ln in fh if "IPs solved" in ln).split()[0])
    return {"instance": name, "argv": argv, "points": int(got.shape[0]),
            "ips": ips, "wall_s": dt, "front_equals_golden": True}


#: device-plane lines that overlay the stream lines (same kernels again)
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework")


def device_busy(fn):
    """Run ``fn`` once under the JAX profiler.  Returns (its result, wall
    seconds, device busy seconds, the five kernels with the most device
    time, the device trace's line names).  Busy is the union of the event
    intervals on the GPU planes' stream lines; the trace is deleted after
    the reduction."""
    import glob
    import shutil

    import jax
    from jax.profiler import ProfileData

    d = out_path("trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        res = fn()
    wall = time.perf_counter() - t0
    spans, by_name, lines = [], {}, set()
    for path in glob.glob(os.path.join(d, "plugins", "profile", "*", "*.xplane.pb")):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                lines.add(line.name)
                if line.name.startswith(_DERIVED_LINES):
                    continue
                for e in line.events:
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
    shutil.rmtree(d)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy_s = busy * 1e-9 if lines else None  # None: no GPU plane traced
    return res, wall, busy_s, [(n, t * 1e-9) for n, t in top], sorted(lines)


# ---------------------------------------------------------------- phase A
def phase_device() -> dict:
    try:
        info = gpu_info()
    except RuntimeError as e:
        raise SystemExit(f"phase A: {e}") from None
    return emit("A.device", **info)


# ---------------------------------------------------------------- phase B
def dp_instance(max_cells: int, seed: int = 11):
    """A generated two-objective knapsack whose DP table is the largest
    that stays within ``max_cells`` (items stepped down by 2)."""
    from moip_aira_tpu.solver import kp_front as kf
    from moip_aira_tpu.utils.generate import kp_lp

    items = max(4, int((max_cells / 3200) ** 0.5) + 8)
    while items >= 4:
        path = out_path("dp_knapsack.lp")
        with open(path, "w") as fh:
            fh.write(kp_lp(items, 2, seed=seed))
        kp = kf.detect_kp2(read_problem(path))
        if kp is not None and kp.table_cells <= max_cells:
            return items, kp
        items -= 2
    raise AssertionError("no knapsack fits the DP table budget")


def phase_dp(max_cells: int = None) -> list:
    from moip_aira_tpu.solver import kp_front as kf

    recs = [emit("B.dp_cli", **run_cli("2KP100.lp", []))]

    items, kp = dp_instance(max_cells or kf.MAX_TABLE_CELLS_NP)
    C_p = kf._round_up(kp.cap + 1, kf._BUCKET)
    S_p = kf._round_up(int(kp.V[1].sum()) + 1, kf._BUCKET)
    steps = kf._round_up(kp.w.shape[0], 64)
    t0 = time.perf_counter()
    got = kf.front_jax(kp)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = kf.front_jax(kp)
    dp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = kf.front_np(kp)
    np_s = time.perf_counter() - t0
    check_front(f"generated {items}-item knapsack", got, want)
    table_bytes = C_p * S_p * 4
    rec = dict(
        items=items, scan_steps=steps, table_cells=kp.table_cells,
        device_table_bytes=table_bytes, points=int(got.shape[0]),
        dp_first_call_s=first_s, dp_s=dp_s, dp_s_per_step=dp_s / steps,
        numpy_dp_s=np_s, equal_to_numpy=True,
    )
    import jax

    peak = PEAK_BYTES_PER_S.get(jax.devices()[0].device_kind)
    if jax.devices()[0].platform == "gpu":
        if peak is None:
            raise KeyError(
                f"no bandwidth peak for {jax.devices()[0].device_kind!r}"
            )
        # bound: each scan step reads and writes the table once
        rec["bandwidth_bound_s_per_step"] = 2 * table_bytes / peak
        rec["bandwidth_share"] = rec["bandwidth_bound_s_per_step"] / rec["dp_s_per_step"]
    recs.append(emit("B.dp_vs_numpy", **rec))

    for name in ("G2KP50.lp", "2KP100.lp"):
        p = read_problem(ex(name))
        want = read_front(ex(name.replace(".lp", ".out")))
        times = {}
        for dp in ("on", "off"):  # device DP, then kp_bb through 'auto'
            solve_front(p, dp=dp)  # warm-up
            t0 = time.perf_counter()
            res = solve_front(p, dp=dp)
            times[dp] = time.perf_counter() - t0
            check_front(name, res.points, want)
        recs.append(emit("B.dp_vs_kpbb", instance=name, n=p.n,
                         dp_s=times["on"], kpbb_s=times["off"]))
    return recs


# ---------------------------------------------------------------- phase C
def phase_bench_grid(n_requests: int = 1920, batch_width: int = 2048) -> dict:
    import jax

    from moip_aira_tpu.solver.lex import NumpyLexBackend
    from moip_aira_tpu.solver.wave import WaveLexBackend
    from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS

    p = read_problem(ex("G2AP05.lp"))
    reqs = grid_requests(read_front(ex("G2AP05.out")), n_requests)
    be = WaveLexBackend(p, batch_width=batch_width, nodes_per_task=32)
    t0 = time.perf_counter()
    be.lex_solve_batch(reqs[:2])
    warm_s = time.perf_counter() - t0
    c0 = {k: getattr(be, k) for k in (
        "device_waves", "lp_count", "verify_fallbacks", "cert_failures",
        "wave_iters", "lane_iters", "req_fallbacks")}
    spans0 = dict(GLOBAL_TIMINGS.totals)
    t0 = time.perf_counter()
    outs = be.lex_solve_batch(reqs)
    wall = time.perf_counter() - t0
    d = {k: getattr(be, k) - v for k, v in c0.items()}
    spans = {k: v - spans0.get(k, 0.0) for k, v in GLOBAL_TIMINGS.totals.items()}

    oracle = NumpyLexBackend(p)
    for r, o in zip(reqs, outs):
        w = oracle.lex_solve(r)
        same = o.status.is_infeasible == w.status.is_infeasible and (
            o.status.is_infeasible or np.array_equal(o.result, w.result)
        )
        if not same:
            raise AssertionError(f"bench grid: {r} gave {o}, NumPy gave {w}")

    _, traced_s, busy_s, top, lines = device_busy(lambda: be.lex_solve_batch(reqs))

    # one full wave of first-stage root LPs, timed alone
    B = batch_width
    nc = be.n + be.m
    c = np.zeros((B, nc))
    lo = np.zeros((B, nc))
    hi = np.zeros((B, nc))
    for i, r in enumerate(reqs[:B]):
        t = be._stage_task(i, 0, list(r.perm), np.asarray(r.rhs, dtype=float))
        c[i] = t.cvec
        lo[i] = np.concatenate([p.lb, t.llo])
        hi[i] = np.concatenate([p.ub, t.lhi])
    jax.block_until_ready(be._lp_batch(c, lo, hi))
    wave_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(be._lp_batch(c, lo, hi))
        wave_s.append(time.perf_counter() - t0)
    it = int(np.asarray(out.iters).max())
    return emit(
        "C.bench_grid", requests=len(reqs), lex_ips=sum(o.ip_solves for o in outs),
        wall_s=wall, warmup_compile_s=warm_s, waves=d["device_waves"],
        lps=d["lp_count"], verify_fallbacks=d["verify_fallbacks"],
        req_fallbacks=d["req_fallbacks"],
        cert_failure_share=d["cert_failures"] / max(1, d["lp_count"]),
        mean_wave_max_iters=d["wave_iters"] / max(1, d["device_waves"]),
        mean_lane_iters=d["lane_iters"] / max(1, d["lp_count"]),
        host_span_s=spans, equal_to_numpy=True,
        traced_wall_s=traced_s, device_busy_s=busy_s,
        device_busy_share=None if busy_s is None else busy_s / traced_s,
        top_kernels_s=top,
        trace_device_lines=lines,
        root_wave_lanes=min(B, len(reqs)), root_wave_s=sorted(wave_s)[1],
        root_wave_max_iters=it,
        root_wave_us_per_iter=sorted(wave_s)[1] / max(1, it) * 1e6,
    )


def phase_lp_boxes(lanes: int = 256, seed: int = 5, instance: str = "2AP40") -> dict:
    """float32 device simplex (as the wave backend builds it) against the
    float64 host simplex on random objective-bound boxes with random
    variable fixings over ``instance``'s constraint matrix."""
    import jax
    import jax.numpy as jnp

    from moip_aira_tpu.solver import simplex_jax as sx
    from moip_aira_tpu.solver.simplex_batch import solve_lp_batch
    from moip_aira_tpu.solver.simplex_np import SimplexWorkspace
    from moip_aira_tpu.solver.status import SolveStatus
    from moip_aira_tpu.solver.verify import LPVerifier

    jax.config.update("jax_enable_x64", True)
    p = read_problem(ex(f"{instance}.lp"))
    front = read_front(ex(f"{instance}.out"))
    A_full = np.vstack([p.A, p.C])
    m = A_full.shape[0]
    W = np.hstack([A_full, -np.eye(m)])
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, p.objcnt, size=lanes)
    c = np.zeros((lanes, p.n + m))
    c[np.arange(lanes), :p.n] = p.C[obj]
    lo = np.tile(np.concatenate([p.lb, p.row_lb, np.full(p.objcnt, -np.inf)]), (lanes, 1))
    hi = np.tile(np.concatenate([p.ub, p.row_ub, np.full(p.objcnt, np.inf)]), (lanes, 1))
    # objective-bound box: cap every objective inside the front's range
    for j in range(p.objcnt):
        hi[:, p.n + p.m_struct + j] = rng.integers(
            front[:, j].min(), front[:, j].max() + 1, size=lanes
        )
    # a few variables fixed at 0 or 1 per lane (branch-and-bound children)
    fix = rng.random((lanes, p.n)) < 2.0 / p.n
    val = rng.integers(0, 2, size=(lanes, p.n)).astype(float)
    lo[:, :p.n] = np.where(fix, val, lo[:, :p.n])
    hi[:, :p.n] = np.where(fix, val, hi[:, :p.n])

    solve = jax.jit(jax.vmap(sx.make_lp_solver(
        jnp.asarray(W, dtype=jnp.float32), 2000, feas_tol=1e-2,
        cost_tol=1e-2, pivot_tol=1e-3, progress_tol=1e-3,
    )))
    args = [jnp.asarray(a, dtype=jnp.float32) for a in (c, lo, hi)]
    t0 = time.perf_counter()
    out = jax.block_until_ready(solve(*args))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(solve(*args))
    dev_s = time.perf_counter() - t0
    status = np.asarray(out.status)
    cert = LPVerifier(W).certify(
        c, lo, hi, status, np.asarray(out.basis), np.asarray(out.at_upper)
    )
    t0 = time.perf_counter()
    ref = solve_lp_batch(SimplexWorkspace(A_full), c[:, :p.n], lo, hi)
    host_s = time.perf_counter() - t0
    ref_status = np.array([
        sx.OPTIMAL if r.status == SolveStatus.OPTIMAL
        else sx.INFEASIBLE if r.status == SolveStatus.INFEASIBLE else -1
        for r in ref
    ])
    if (ref_status < 0).any():
        raise AssertionError("float64 host simplex did not finish every lane")
    ref_obj = np.array([r.obj if r.status == SolveStatus.OPTIMAL else np.nan for r in ref])
    scale = np.maximum(1.0, np.abs(ref_obj))
    ok = cert.ok
    bad_status = ok & (status != ref_status)
    both_opt = ok & (status == sx.OPTIMAL) & (ref_status == sx.OPTIMAL)
    # the value the wave adopts for a certified lane: the f64 vertex at the
    # device's basis (it prunes on cert.dual_bound, never on the f32 value)
    rel_cert = np.abs(cert.obj - ref_obj) / scale
    # the device's own float32 objective, reported beside it
    rel_f32 = np.abs(np.asarray(out.obj, dtype=np.float64) - ref_obj) / scale
    bad_obj = both_opt & ~(rel_cert <= LP_OBJ_RTOL)
    if bad_status.any() or bad_obj.any():
        raise AssertionError(
            f"LP boxes: {int(bad_status.sum())} certified lanes disagree on "
            f"status, {int(bad_obj.sum())} on the certified objective"
        )
    return emit(
        "C.lp_boxes", instance=instance, lanes=lanes, rows=m, columns=p.n,
        certified_share=float(ok.mean()),
        optimal_lanes=int((ref_status == sx.OPTIMAL).sum()),
        infeasible_lanes=int((ref_status == sx.INFEASIBLE).sum()),
        max_rel_obj_err_certified=float(rel_cert[both_opt].max(initial=0.0)),
        max_rel_obj_err_f32=float(rel_f32[both_opt].max(initial=0.0)),
        f32_obj_over_tol_lanes=int((both_opt & (rel_f32 > LP_OBJ_RTOL)).sum()),
        uncertified_status_mismatch=int((~ok & (status != ref_status)).sum()),
        device_max_iters=int(np.asarray(out.iters).max()),
        device_first_call_s=first_s, device_s=dev_s, host_f64_s=host_s,
        equal_within_tolerance=True,
    )


def phase_cli_fronts() -> list:
    import jax

    p = read_problem(ex("moip_2_30_knapsack.mop"))
    route = make_backend(p, "auto").name
    if jax.devices()[0].platform == "gpu" and route != "wave":
        raise AssertionError(f"the .mop instance routed to {route!r}, not 'wave'")
    rec = run_cli("moip_2_30_knapsack.mop", [])
    if rec["ips"] == 0:  # the knapsack DP writes 0 IPs
        raise AssertionError("the .mop instance did not take the lex-IP route")
    recs = [emit("C.cli_auto", route=route, **rec)]
    for name in ("G3AP05.lp", "G3KP10.lp"):
        recs.append(emit("C.cli_wave_k3",
                         **run_cli(name, ["--backend", "wave", "-t", "2"])))
    return recs


def phase_wave_2ap20() -> dict:
    p = read_problem(ex("2AP20.lp"))
    be = make_backend(p, "wave")
    t0 = time.perf_counter()
    res = solve_front(p, backend=be)
    wall = time.perf_counter() - t0
    check_front("2AP20.lp", res.points, read_front(ex("2AP20.out")))
    return emit(
        "C.wave_2ap20", points=res.solution_count, wall_s=wall,
        lex_ips=res.ip_count, waves=be.device_waves, lps=be.lp_count,
        verify_fallbacks=be.verify_fallbacks, req_fallbacks=be.req_fallbacks,
        cert_failure_share=be.cert_failures / max(1, be.lp_count),
        mean_wave_max_iters=be.wave_iters / max(1, be.device_waves),
        front_equals_golden=True,
    )


# ---------------------------------------------------------------- phase D
def phase_monolithic() -> list:
    return [emit("D.jax", **run_cli(name, ["--backend", "jax"]))
            for name in ("G2AP05.lp", "G3KP10.lp")]


# ---------------------------------------------------------------- phase E
def phase_mesh(n_devices: int = 4) -> dict:
    import jax

    p = read_problem(ex("G3AP05.lp"))
    want = read_front(ex("G3AP05.out"))
    be = make_backend(p, "wave", mesh_devices=n_devices)
    t0 = time.perf_counter()
    res = solve_front(p, n_workers=6, backend=be, mesh_devices=n_devices)
    mesh_s = time.perf_counter() - t0
    check_front(f"G3AP05 on {n_devices} devices", res.points, want)
    t0 = time.perf_counter()
    one = solve_front(p, n_workers=6, backend="wave")
    one_s = time.perf_counter() - t0
    check_front("G3AP05 on one device", one.points, want)
    # one wave's batch: which devices hold its shards
    nc = be.n + be.m
    z = np.zeros((be.batch_width, nc))
    out = jax.block_until_ready(be._lp_batch(z, z, z))
    shards = sorted(
        (str(s.device), int(s.data.shape[0])) for s in out.obj.addressable_shards
    )
    if len({d for d, _ in shards}) != n_devices:
        raise AssertionError(f"wave batch not spread over {n_devices} devices: {shards}")
    return emit(
        "E.mesh", devices=n_devices, mesh_shape=dict(be.mesh.shape),
        mesh_wall_s=mesh_s, mesh_ips=res.ip_count, mesh_rounds=res.rounds,
        domain_ips=res.domain_ips, one_device_wall_s=one_s,
        one_device_ips=one.ip_count, wave_shards=shards,
        fronts_equal_golden=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="1: phases A-D; 4: phase A and the mesh phase E")
    args = ap.parse_args(argv)

    device = phase_device()
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    t_start = time.perf_counter()
    if args.chips > 1:
        if device["count"] < args.chips:
            raise SystemExit(f"--chips {args.chips}: JAX sees {device['count']} GPUs")
        phase_mesh(args.chips)
    else:
        phase_dp()
        phase_bench_grid()
        phase_lp_boxes()
        phase_cli_fronts()
        phase_wave_2ap20()
        phase_monolithic()
    emit("total", wall_s=time.perf_counter() - t_start)
    with open(out_path(f"records_{args.chips}.json"), "w") as fh:
        json.dump(_RECORDS, fh, indent=1, default=float)
    for line in device["nvidia_smi"]:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
