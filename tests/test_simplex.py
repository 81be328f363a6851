"""LP kernel tests: NumPy oracle vs scipy.linprog, and JAX kernel vs NumPy."""

import numpy as np
import pytest
from scipy.optimize import linprog

from moip_aira_tpu.solver.simplex_np import SimplexWorkspace, solve_lp
from moip_aira_tpu.solver.status import SolveStatus


def random_lp(rng, m, n):
    A = rng.integers(-5, 6, size=(m, n)).astype(float)
    lb = np.zeros(n)
    ub = rng.integers(1, 5, size=n).astype(float)
    # random row bounds around a random feasible point
    x0 = rng.uniform(0, 1, size=n) * ub
    act = A @ x0
    row_lb = np.where(rng.random(m) < 0.5, act - rng.integers(0, 4, m), -np.inf)
    row_ub = np.where(rng.random(m) < 0.5, act + rng.integers(0, 4, m), np.inf)
    c = rng.integers(-9, 10, size=n).astype(float)
    return A, row_lb, row_ub, lb, ub, c


def scipy_solve(A, row_lb, row_ub, lb, ub, c):
    A_ub, b_ub = [], []
    for i in range(A.shape[0]):
        if np.isfinite(row_ub[i]):
            A_ub.append(A[i])
            b_ub.append(row_ub[i])
        if np.isfinite(row_lb[i]):
            A_ub.append(-A[i])
            b_ub.append(-row_lb[i])
    res = linprog(
        c,
        A_ub=np.array(A_ub) if A_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        bounds=list(zip(lb, ub)),
        method="highs",
    )
    return res


@pytest.mark.parametrize("seed", range(30))
def test_numpy_simplex_vs_scipy(seed):
    rng = np.random.default_rng(seed)
    m, n = rng.integers(2, 7), rng.integers(2, 9)
    A, row_lb, row_ub, lb, ub, c = random_lp(rng, m, n)
    ws = SimplexWorkspace(A)
    lo = np.concatenate([lb, row_lb])
    hi = np.concatenate([ub, row_ub])
    mine = solve_lp(ws, c, lo, hi)
    ref = scipy_solve(A, row_lb, row_ub, lb, ub, c)
    if ref.status == 2:  # infeasible
        assert mine.status == SolveStatus.INFEASIBLE
    elif ref.status == 0:
        assert mine.status == SolveStatus.OPTIMAL
        assert mine.obj == pytest.approx(ref.fun, abs=1e-6)
    # (unbounded cannot occur: all variable bounds finite)


def test_equality_rows():
    # x + y = 3, minimise x  ->  x=0 (y=3 needs ub >= 3)
    A = np.array([[1.0, 1.0]])
    ws = SimplexWorkspace(A)
    lo = np.array([0.0, 0.0, 3.0])
    hi = np.array([5.0, 5.0, 3.0])
    r = solve_lp(ws, np.array([1.0, 0.0]), lo, hi)
    assert r.status == SolveStatus.OPTIMAL
    assert r.obj == pytest.approx(0.0)


def test_infeasible_box():
    A = np.array([[1.0, 1.0]])
    ws = SimplexWorkspace(A)
    # x + y = 10 but ub sums to 4
    lo = np.array([0.0, 0.0, 10.0])
    hi = np.array([2.0, 2.0, 10.0])
    r = solve_lp(ws, np.array([1.0, 1.0]), lo, hi)
    assert r.status == SolveStatus.INFEASIBLE


@pytest.mark.parametrize("seed", range(10))
def test_jax_simplex_matches_numpy(seed):
    import jax.numpy as jnp

    from moip_aira_tpu.solver import simplex_jax as sx

    rng = np.random.default_rng(100 + seed)
    m, n = rng.integers(2, 6), rng.integers(2, 7)
    A, row_lb, row_ub, lb, ub, c = random_lp(rng, m, n)
    ws = SimplexWorkspace(A)
    lo = np.concatenate([lb, row_lb])
    hi = np.concatenate([ub, row_ub])
    mine = solve_lp(ws, c, lo, hi)

    W = jnp.asarray(ws.W)
    jsolve = sx.make_lp_solver(W, 2000)
    c_full = jnp.concatenate([jnp.asarray(c), jnp.zeros(m)])
    out = jsolve(c_full, jnp.asarray(lo), jnp.asarray(hi))
    if mine.status == SolveStatus.OPTIMAL:
        assert int(out.status) == sx.OPTIMAL
        assert float(out.obj) == pytest.approx(mine.obj, abs=1e-6)
    elif mine.status == SolveStatus.INFEASIBLE:
        assert int(out.status) == sx.INFEASIBLE


def test_jax_simplex_infinite_upper_bounds():
    """Variables with infinite upper bounds (the .mop family's general
    integers) entering the basis keep that bound infinite: the float32
    device kernel, as the wave backend builds it, reaches the f64 oracle's
    optimum on the bundled MOP instance's first-objective LP."""
    import jax
    import jax.numpy as jnp

    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.solver import simplex_jax as sx

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/moip_2_30_knapsack.mop")
    A_full = np.vstack([p.A, p.C])
    m = A_full.shape[0]
    W = np.hstack([A_full, -np.eye(m)])
    lo = np.concatenate([p.lb, p.row_lb, [-np.inf] * p.objcnt])
    hi = np.concatenate([p.ub, p.row_ub, [np.inf] * p.objcnt])
    assert np.isinf(hi[: p.n]).all()
    c = np.concatenate([p.C[0], np.zeros(m)])
    want = solve_lp(SimplexWorkspace(A_full), p.C[0], lo, hi)
    assert want.status == SolveStatus.OPTIMAL
    solve = jax.jit(jax.vmap(sx.make_lp_solver(
        jnp.asarray(W, dtype=jnp.float32), 2000, feas_tol=1e-2,
        cost_tol=1e-2, pivot_tol=1e-3, progress_tol=1e-3,
    )))
    B = 4

    def tile(a):
        return jnp.asarray(np.tile(a, (B, 1)), dtype=jnp.float32)

    out = solve(tile(c), tile(lo), tile(hi))
    assert (np.asarray(out.status) == sx.OPTIMAL).all()
    assert np.allclose(
        np.asarray(out.obj), want.obj, rtol=0, atol=1e-3 * max(1.0, abs(want.obj))
    )


def test_certificate_rejects_at_upper_with_infinite_bound():
    """Soundness: at_upper on an infinite-bound nonbasic column must fail
    certification even when the reduced-cost signs happen to line up."""
    from moip_aira_tpu.solver import simplex_jax as sx
    from moip_aira_tpu.solver.verify import LPVerifier

    A = np.array([[1.0, 1.0]])
    W = np.hstack([A, -np.eye(1)])
    v = LPVerifier(W)
    B = 1
    c = np.array([[-1.0, -2.0, 0.0]])
    lo = np.array([[0.0, 0.0, -np.inf]])
    hi = np.array([[np.inf, np.inf, 10.0]])
    status = np.array([sx.OPTIMAL], dtype=np.int32)
    basis = np.array([[2]], dtype=np.int32)  # logical basic
    at_upper = np.array([[True, True, False]])  # bogus: hi = inf
    cert = v.certify(c, lo, hi, status, basis, at_upper)
    assert not cert.ok[0]


def test_warm_start_drift_regression():
    """Captured from a real failure: a garbage f32 device basis (a since
    removed device kernel's mid-phase-1 state) warm-started ~7k pivots whose
    rank-1 tableau updates drifted until phase-1 declared this feasible
    2AP40 node LP INFEASIBLE — which pruned the node holding the true
    stage optimum and emitted a dominated point.  solve_lp must now reach
    the exact optimum (259) from this warm basis: the competitive
    warm/cold start rejects the garbage basis, and refactor-verified
    termination would catch the drift even if it were accepted."""
    import os

    from moip_aira_tpu.io import read_problem

    data = np.load(
        os.path.join(os.path.dirname(__file__), "data",
                     "simplex_warm_drift_2ap40.npz")
    )
    from conftest import REPO

    p = read_problem(os.path.join(REPO, "examples", "2AP40.lp"))
    ws = SimplexWorkspace(np.vstack([p.A, p.C]))
    r_warm = solve_lp(
        ws, data["c"], data["lo"], data["hi"],
        warm_basis=data["wb"], warm_at_upper=data["wa"],
    )
    r_cold = solve_lp(ws, data["c"], data["lo"], data["hi"])
    assert r_cold.status == SolveStatus.OPTIMAL
    assert r_warm.status == SolveStatus.OPTIMAL
    assert abs(r_cold.obj - 259.0) < 1e-6
    assert abs(r_warm.obj - r_cold.obj) < 1e-6
