"""Tests for the bi-objective knapsack full-front DP (solver/kp_front.py).

Contract: on every instance it detects, the DP must produce exactly the
front the general AIRA engine (and the reference goldens) produce —
detection is only ever allowed to be conservative.
"""

import numpy as np
import pytest

from moip_aira_tpu.api import solve_front
from moip_aira_tpu.io import read_problem
from moip_aira_tpu.solver import kp_front as kf

from conftest import EXAMPLES, golden_front


def _golden_front(name: str) -> np.ndarray:
    return golden_front(name)


# ---- detection ------------------------------------------------------------


def test_detects_reference_2kp50():
    p = read_problem(f"{EXAMPLES}/G2KP50.lp")
    kp = kf.detect_kp2(p)
    assert kp is not None
    assert kp.negate is False
    assert kp.cap == 2055  # floor of the fractional capacity 2055.5


def test_detects_reference_mop():
    p = read_problem(f"{EXAMPLES}/moip_2_30_knapsack.mop")
    kp = kf.detect_kp2(p)
    assert kp is not None
    assert kp.negate is True  # minimised negative values


def test_rejects_three_objectives():
    p = read_problem(f"{EXAMPLES}/G3KP10.lp")
    assert kf.detect_kp2(p) is None


def test_rejects_assignment():
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    assert kf.detect_kp2(p) is None


# ---- front parity ---------------------------------------------------------


def test_2kp50_front_matches_golden_np_and_jax():
    p = read_problem(f"{EXAMPLES}/G2KP50.lp")
    kp = kf.detect_kp2(p)
    want = _golden_front("G2KP50")
    got_np = kf.front_np(kp)
    assert np.array_equal(got_np, want)
    got_jax = kf.front_jax(kp)
    assert np.array_equal(got_jax, want)


@pytest.mark.slow
def test_mop_front_matches_golden():
    p = read_problem(f"{EXAMPLES}/moip_2_30_knapsack.mop")
    kp = kf.detect_kp2(p)
    got = kf.front_jax(kp)
    want = _golden_front("moip_2_30_knapsack")
    assert np.array_equal(got, want)


def test_api_routes_dp_and_matches_golden():
    p = read_problem(f"{EXAMPLES}/G2KP50.lp")
    front = solve_front(p, dp="on")
    want = _golden_front("G2KP50")
    assert np.array_equal(front.points, want)
    assert front.ip_count == 0  # no MIPs were solved


# ---- differential vs the AIRA engine on random instances ------------------


@pytest.mark.parametrize("seed", range(6))
def test_random_kp_dp_vs_aira(seed):
    from moip_aira_tpu.utils.generate import kp_lp

    text = kp_lp(items=14, objectives=2, seed=seed, vlo=3, vhi=20)
    import tempfile, os

    with tempfile.NamedTemporaryFile(
        "w", suffix=".lp", delete=False
    ) as fh:
        fh.write(text)
        path = fh.name
    try:
        p = read_problem(path)
        kp = kf.detect_kp2(p)
        assert kp is not None
        dp_pts = kf.front_np(kp)
        aira = solve_front(p, backend="numpy", dp="off")
        assert np.array_equal(dp_pts, aira.points), (
            f"seed {seed}: DP front != AIRA front"
        )
    finally:
        os.unlink(path)


@pytest.mark.parametrize("seed", range(3))
def test_random_bounded_integer_kp(seed):
    """Multiplicity expansion: integer vars with ub > 1."""
    from moip_aira_tpu.utils.generate import kp_mop

    text = kp_mop(items=8, objectives=2, seed=seed, vlo=3, vhi=15, integer_ub=3)
    import tempfile, os

    with tempfile.NamedTemporaryFile(
        "w", suffix=".mop", delete=False
    ) as fh:
        fh.write(text)
        path = fh.name
    try:
        p = read_problem(path)
        kp = kf.detect_kp2(p)
        assert kp is not None
        dp_pts = kf.front_np(kp)
        aira = solve_front(p, backend="numpy", dp="off")
        assert np.array_equal(dp_pts, aira.points)
    finally:
        os.unlink(path)


def test_jax_equals_np_random():
    from moip_aira_tpu.utils.generate import kp_lp
    import tempfile, os

    text = kp_lp(items=25, objectives=2, seed=99, vlo=5, vhi=30)
    with tempfile.NamedTemporaryFile("w", suffix=".lp", delete=False) as fh:
        fh.write(text)
        path = fh.name
    try:
        p = read_problem(path)
        kp = kf.detect_kp2(p)
        assert np.array_equal(kf.front_np(kp), kf.front_jax(kp))
    finally:
        os.unlink(path)
