"""Exactness of the combinatorial knapsack engine (solver/kp_bb.py).

Three contracts:
  * detection accepts exactly the knapsack family (one-sided nonneg rows,
    binary vars) and rejects the assignment family's equality rows;
  * random-instance differential: the kpbb front equals the brute-force
    front, and single IPs equal the exact LP-based MIP solver, across both
    the MAX form and the mirrored (.mop-style MIN/nonpos) form;
  * golden: the bundled KP2D instances reproduce their oracle-verified
    fronts through the production auto-routing.
"""

import numpy as np
import pytest

from moip_aira_tpu.api import make_backend, solve_front
from moip_aira_tpu.io import read_problem
from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense
from moip_aira_tpu.solver.kp_bb import (
    KnapsackLexBackend,
    KPIPSolver,
    detect_kp_family,
)
from moip_aira_tpu.solver.lex import LexRequest, NumpyLexBackend

from conftest import EXAMPLES
from test_differential import brute_force_front


def random_kp(seed: int, k: int = 2, ncap: int = 2, mirror: bool = False):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 14))
    W = rng.integers(1, 30, size=(ncap, n)).astype(float)
    b = np.floor(W.sum(axis=1) * rng.uniform(0.3, 0.7, size=ncap))
    C = rng.integers(0, 25, size=(k, n)).astype(float)
    if mirror:
        return Problem(
            objcnt=k,
            objsen=Sense.MIN,
            var_names=[f"x{i}" for i in range(n)],
            C=-C,
            A=-W,
            row_lb=-b,
            row_ub=np.full(ncap, INF),
            lb=np.zeros(n),
            ub=np.ones(n),
            is_int=np.ones(n, dtype=bool),
            filename=f"rkp-mirror-{seed}",
        )
    return Problem(
        objcnt=k,
        objsen=Sense.MAX,
        var_names=[f"x{i}" for i in range(n)],
        C=C,
        A=W,
        row_lb=np.full(ncap, -INF),
        row_ub=b,
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.ones(n, dtype=bool),
        filename=f"rkp-{seed}",
    )


def test_detects_bundled_kp2d():
    p = read_problem(f"{EXAMPLES}/KP2D50.lp")
    fam = detect_kp_family(p)
    assert fam is not None
    assert fam.W.shape == (2, 50)
    assert not fam.mirror
    assert make_backend(p, "auto").name == "kpbb"


def test_rejects_assignment_family():
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    assert detect_kp_family(p) is None


def test_detects_mirrored_mop():
    p = read_problem(f"{EXAMPLES}/moip_2_30_knapsack.mop")
    fam = detect_kp_family(p)
    if fam is not None:
        assert fam.mirror


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("mirror", [False, True])
def test_front_matches_brute_force(seed, mirror):
    p = random_kp(seed, k=2, mirror=mirror)
    fam = detect_kp_family(p)
    assert fam is not None
    assert fam.mirror == mirror
    res = solve_front(p, n_workers=2, backend="kpbb", dp="off")
    expected = brute_force_front(p)
    assert res.points.shape == expected.shape
    assert (res.points == expected).all()


@pytest.mark.parametrize("seed", range(4))
def test_three_objective_front(seed):
    p = random_kp(100 + seed, k=3)
    res = solve_front(p, n_workers=2, backend="kpbb", dp="off")
    expected = brute_force_front(p)
    assert res.points.shape == expected.shape
    assert (res.points == expected).all()


@pytest.mark.parametrize("seed", range(8))
def test_single_ip_matches_lp_mip(seed):
    """One lex solve (with tight boxes) vs the exact LP-based backend."""
    p = random_kp(200 + seed, k=2)
    kp = KnapsackLexBackend(p)
    ref = NumpyLexBackend(p)
    # box one objective near the middle of its range to force covers
    r0 = kp.lex_solve(LexRequest(rhs=p.initial_rhs(), perm=[0, 1]))
    assert r0.status == 0
    mid = r0.result[1] // 2 + 1
    rhs = p.initial_rhs()
    rhs[1] = float(mid)
    for perm in ([0, 1], [1, 0]):
        a = kp.lex_solve(LexRequest(rhs=rhs, perm=perm))
        b = ref.lex_solve(LexRequest(rhs=rhs, perm=perm))
        assert a.status == b.status
        if a.status == 0:
            assert (a.result == b.result).all()


def test_infeasible_box():
    p = random_kp(300, k=2)
    kp = KnapsackLexBackend(p)
    rhs = p.initial_rhs()
    rhs[0] = 10**9  # unattainable cover
    out = kp.lex_solve(LexRequest(rhs=rhs, perm=[0, 1]))
    assert out.status.is_infeasible


def test_pool_and_pegging_paths_exercise():
    """A medium instance large enough to trigger the budgeted dive +
    pegging restart still matches brute force."""
    rng = np.random.default_rng(7)
    n = 16
    W = rng.integers(20, 40, size=(2, n)).astype(float)
    b = np.floor(W.sum(axis=1) * 0.5)
    C = rng.integers(20, 40, size=(2, n)).astype(float)
    p = Problem(
        objcnt=2, objsen=Sense.MAX,
        var_names=[f"x{i}" for i in range(n)],
        C=C, A=W, row_lb=np.full(2, -INF), row_ub=b,
        lb=np.zeros(n), ub=np.ones(n), is_int=np.ones(n, dtype=bool),
        filename="peg-test",
    )
    res = solve_front(p, n_workers=2, backend="kpbb", dp="off")
    expected = brute_force_front(p)
    assert res.points.shape == expected.shape
    assert (res.points == expected).all()


def test_golden_kp2d50():
    p = read_problem(f"{EXAMPLES}/KP2D50.lp")
    res = solve_front(p, n_workers=2, backend="kpbb", dp="off")
    golden = []
    with open(f"{EXAMPLES}/KP2D50.out") as fh:
        for line in fh:
            t = line.split()
            if t and all(x.lstrip("-").isdigit() for x in t):
                golden.append([int(x) for x in t])
    g = np.asarray(golden, dtype=np.int64)
    assert res.points.shape == g.shape
    assert (res.points == g).all()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["KP2D100", "KP2D200"])
def test_golden_kp2d_ladder(name):
    p = read_problem(f"{EXAMPLES}/{name}.lp")
    res = solve_front(p, n_workers=2, backend="kpbb", dp="off")
    golden = []
    with open(f"{EXAMPLES}/{name}.out") as fh:
        for line in fh:
            t = line.split()
            if t and all(x.lstrip("-").isdigit() for x in t):
                golden.append([int(x) for x in t])
    g = np.asarray(golden, dtype=np.int64)
    assert res.points.shape == g.shape
    assert (res.points == g).all()
