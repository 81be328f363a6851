"""Multi-device weak-scaling benchmark — the distributed enumeration path.

Measures `solve_front` through the MeshScheduler (domain-partitioned AIRA
workers + cross-domain box/ideal-point exchange collectives) at several
mesh sizes over the devices JAX finds: the GPUs of one host, or a virtual
CPU mesh (`JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8`),
the same substrate `dryrun_multichip` validates.  Every row names its
device.

Two backends per mesh size:
  numpy — isolates the scheduler + collective overhead (host LPs, no
          device kernels)
  wave  — the production path (batched device LP kernel sharded over the
          mesh)

Writes .bench_scale/BENCH_MESH.md + BENCH_MESH.json.  Run:
    python bench_mesh.py [--sizes 1 2 4 8] [--instance G3AP05] [--workers 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, ".bench_scale")


def run_one(
    name: str, backend: str, mesh_n: int, workers: int, mode: str
) -> dict:
    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.io import read_problem

    os.environ["MOIP_MESH_MODE"] = mode

    p = read_problem(os.path.join(REPO, "examples", f"{name}.lp"))
    # warm-up (compiles the CPU kernels / collective programs)
    solve_front(
        p, n_workers=workers, backend=backend, mesh_devices=mesh_n, dp="off"
    )
    t0 = time.monotonic()
    res = solve_front(
        p, n_workers=workers, backend=backend, mesh_devices=mesh_n, dp="off"
    )
    dt = time.monotonic() - t0
    crit = (
        res.pre_ips + max(res.domain_ips)
        if res.domain_ips
        else res.ip_count
    )
    dev = jax.devices()[0]
    return {
        "instance": name,
        "backend": backend,
        "mode": mode,
        "mesh": mesh_n,
        "workers": workers,
        "device": f"{dev.platform} {dev.device_kind}",
        "elapsed_s": round(dt, 2),
        "points": res.solution_count,
        "ips": res.ip_count,
        # critical path = shared pre-work + the busiest domain: what a
        # real multi-chip deployment's wall clock tracks (each domain's
        # round batch runs on its own device; this process is one host)
        "crit_ips": crit,
        "ips_per_s": round(res.ip_count / dt, 1),
        "rounds": res.rounds,
    }


def render(rows: list) -> str:
    out = [
        "# BENCH_MESH — distributed-enumeration weak scaling",
        "",
        "Mesh = N devices of the row's `device` (GPUs of one host, or virtual",
        "CPU devices via `--xla_force_host_platform_device_count`).  Workers",
        "are domain-partitioned over devices; each round ends in a",
        "cross-domain infeasible-box allgather + ideal-point pmin/pmax",
        "allreduce (parallel/mesh.py).  `numpy` rows isolate",
        "scheduler+collective behaviour; `wave` rows run the device LP path.",
        "",
        "Modes: `strip` (round-5 default) partitions domains by EPP range —",
        "domains own DISJOINT slices of the last objective, so total IPs",
        "should stay ~flat as the mesh grows; `sync` is the severed-cell",
        "synergistic mode (round 2-4), whose domain-private stores multiply",
        "IPs with mesh size (the round-4 anti-scaling finding).  The",
        "reference's own workers share one address space (lockingvars.h);",
        "strip mode is its `--split` decomposition mapped onto devices.",
        "",
        "`crit IPs` = shared pre-work + busiest domain's IPs: the",
        "device-parallel critical path a real multi-chip wall clock",
        "tracks (this harness executes all domains in ONE host process,",
        "so `elapsed` carries the sequential backend + collective",
        "overhead and cannot show the multi-chip win directly).",
        "",
        "| instance | backend | mode | mesh | workers | elapsed s | IPs | crit IPs | IP/s | rounds | points | device |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            "| {instance} | {backend} | {mode} | {mesh} | {workers} |"
            " {elapsed_s} | {ips} | {crit_ips} | {ips_per_s} | {rounds} |"
            " {points} | {device} |".format(
                **{"mode": "sync", "device": "?", "crit_ips": "—", **r}
            )
        )
    out.append("")
    out.append(
        f"_Last update: {time.strftime('%Y-%m-%d %H:%M')} — raw rows in"
        " BENCH_MESH.json_"
    )
    out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="*", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--instance", default="G3AP05")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--backends", nargs="*", default=["numpy", "wave"])
    ap.add_argument("--modes", nargs="*", default=["strip", "sync"])
    args = ap.parse_args(argv)

    rows = []
    os.makedirs(OUT_DIR, exist_ok=True)
    jpath = os.path.join(OUT_DIR, "BENCH_MESH.json")
    if os.path.exists(jpath):
        with open(jpath) as fh:
            rows = json.load(fh)
    for mode in args.modes:
        for be in args.backends:
            for n in args.sizes:
                row = run_one(args.instance, be, n, args.workers, mode)
                print(json.dumps(row), flush=True)
                rows = [
                    r
                    for r in rows
                    if not (
                        r["instance"] == row["instance"]
                        and r["backend"] == row["backend"]
                        and r.get("mode", "sync") == row["mode"]
                        and r["mesh"] == row["mesh"]
                        and r["workers"] == row["workers"]
                    )
                ] + [row]
                rows.sort(
                    key=lambda r: (
                        r["instance"], r.get("mode", "sync"), r["backend"],
                        r["mesh"],
                    )
                )
                with open(jpath, "w") as fh:
                    json.dump(rows, fh, indent=1)
                with open(os.path.join(OUT_DIR, "BENCH_MESH.md"), "w") as fh:
                    fh.write(render(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
