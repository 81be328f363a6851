"""Self-consistency tests on the bundled (generated) example instances.

The repo is standalone: `examples/` holds instances from
utils/generate.py with committed golden fronts.  Every decomposition must
reproduce the same front — the reference's own 5-config invariant
(Examples/CMakeLists.txt:4-28) applied to our instances.
"""

import os

import numpy as np
import pytest

from moip_aira_tpu.api import solve_front
from moip_aira_tpu.io import read_problem

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")

CASES = [f for f in ["G2AP05", "G3AP05", "G3KP10"] if os.path.exists(f"{EX}/{f}.out")]
SLOW_CASES = [f for f in ["G2KP50"] if os.path.exists(f"{EX}/{f}.out")]


def bundled_front(name):
    rows = []
    with open(f"{EX}/{name}.out") as fh:
        for line in fh:
            parts = line.split()
            if parts and all(p.lstrip("-").isdigit() for p in parts):
                rows.append([int(p) for p in parts])
    return np.array(rows)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize(
    "cfg",
    [
        dict(n_workers=1),
        dict(n_workers=3),
        dict(n_workers=2, spread=False),
        dict(n_workers=2, split=True),
        dict(n_workers=3, split=True, split_normal=True),
    ],
    ids=["t1", "t3", "t2-cluster", "t2-split", "t3-split-normal"],
)
def test_bundled_golden(name, cfg):
    p = read_problem(f"{EX}/{name}.lp")
    front = solve_front(p, backend="numpy", **cfg)
    expect = bundled_front(name)
    assert front.points.shape == expect.shape
    assert (front.points == expect).all()


def test_generator_roundtrip(tmp_path):
    from moip_aira_tpu.utils.generate import ap_lp, kp_lp, kp_mop

    f = tmp_path / "ap.lp"
    f.write_text(ap_lp(4, 2, seed=9))
    p = read_problem(str(f))
    assert p.objcnt == 2 and p.n == 16 and p.m_struct == 8
    front = solve_front(p, backend="numpy")
    assert front.solution_count >= 1
    # front must be mutually nondominated
    pts = front.points
    for i in range(len(pts)):
        for j in range(len(pts)):
            if i != j:
                assert not (
                    (pts[i] <= pts[j]).all() and (pts[i] < pts[j]).any()
                )

    g = tmp_path / "kp.mop"
    g.write_text(kp_mop(8, 2, seed=9, integer_ub=3))
    q = read_problem(str(g))
    assert q.objcnt == 2 and q.n == 8
    assert (q.ub == 3).all()
    front2 = solve_front(q, backend="numpy")
    assert front2.solution_count >= 1


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW_CASES)
def test_bundled_golden_slow(name):
    p = read_problem(f"{EX}/{name}.lp")
    front = solve_front(p, n_workers=2, backend="numpy")
    expect = bundled_front(name)
    assert front.points.shape == expect.shape
    assert (front.points == expect).all()


@pytest.mark.slow
def test_bundled_mop_golden():
    p = read_problem(f"{EX}/moip_2_30_knapsack.mop")
    front = solve_front(p, n_workers=2, backend="numpy")
    expect = bundled_front("moip_2_30_knapsack")
    assert front.points.shape == expect.shape
    assert (front.points == expect).all()


@pytest.mark.slow
def test_bundled_kp2d50_wave():
    """KP2D family (2 capacity rows — the paper's KP2D workload, SURVEY §6):
    the wave backend reproduces the bundled golden front.  The golden was
    differentially verified against the numpy oracle (35 pts, 74 IPs; the
    oracle takes ~690 s, the wave backend ~40 s on CPU), so this exercises
    the general AIRA+B&B path on an instance the kp_front DP cannot take
    (two capacity rows)."""
    p = read_problem(f"{EX}/KP2D50.lp")
    front = solve_front(p, n_workers=2, backend="wave")
    expect = bundled_front("KP2D50")
    assert front.points.shape == expect.shape
    assert (front.points == expect).all()


@pytest.mark.slow
def test_generated_2ap08_modes_agree(tmp_path):
    """Scale smoke: a generated 8x8 assignment instance (64 binaries) gives
    identical fronts across synergistic, EPP and the wave backend."""
    from moip_aira_tpu.utils.generate import ap_lp

    f = tmp_path / "2AP08.lp"
    f.write_text(ap_lp(8, 2, seed=21))
    p = read_problem(str(f))
    a = solve_front(p, n_workers=2, backend="numpy")
    b = solve_front(p, n_workers=2, split=True, backend="numpy")
    c = solve_front(p, n_workers=2, backend="wave")
    assert a.solution_count == 15
    assert (a.points == b.points).all()
    assert (a.points == c.points).all()


@pytest.mark.slow
def test_bundled_2kp100_dp_golden():
    """2KP100 — the reference's mid-size knapsack workload class
    (1701.08920 Timing.ods).  The bundled golden was produced by the jax
    DP engine and independently re-verified by the numpy DP oracle; here
    the jax DP (CPU) must reproduce it."""
    from moip_aira_tpu.solver import kp_front as kf

    p = read_problem(f"{EX}/2KP100.lp")
    kp = kf.detect_kp2(p)
    assert kp is not None
    expect = bundled_front("2KP100")
    assert expect.shape == (77, 2)
    got = kf.front_jax(kp)
    assert np.array_equal(got, expect)
