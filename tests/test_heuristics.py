"""Unit tests for solver/heuristics.py — incl. the capped swap scan at scale."""

import numpy as np
import pytest

from moip_aira_tpu.solver.heuristics import (
    SWAP_FULL_LIMIT,
    candidate_value,
    local_search,
)


def _knap(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(10, 40, n).astype(float)
    v = rng.integers(10, 40, n).astype(float)
    cap = 0.5 * w.sum()
    Wx = w[None, :]
    lo = np.concatenate([np.zeros(n), [-np.inf]])
    hi = np.concatenate([np.ones(n), [cap]])
    return Wx, -v, lo, hi  # minimise -value


def test_local_search_improves_small():
    Wx, c, lo, hi = _knap(40, 0)
    x0 = np.zeros(40)
    x, v = local_search(Wx, c, lo, hi, x0, np.arange(40))
    assert v < 0.0  # picked something
    assert candidate_value(Wx, c, lo, hi, x) == pytest.approx(v)


def test_local_search_large_n_capped_swaps_fast_and_feasible():
    n = SWAP_FULL_LIMIT * 4  # forces the candidate-subset path
    Wx, c, lo, hi = _knap(n, 1)
    x0 = np.zeros(n)
    x, v = local_search(Wx, c, lo, hi, x0, np.arange(n), max_moves=50)
    assert candidate_value(Wx, c, lo, hi, x) == pytest.approx(v)
    assert v < 0.0


def test_local_search_swap_on_equality_rows():
    # assignment-style: unit moves are never feasible, only swaps are
    n = 4
    Wx = np.ones((1, n))
    c = np.array([5.0, 1.0, 4.0, 2.0])
    lo = np.concatenate([np.zeros(n), [1.0]])
    hi = np.concatenate([np.ones(n), [1.0]])  # sum x == 1
    x0 = np.array([1.0, 0.0, 0.0, 0.0])
    x, v = local_search(Wx, c, lo, hi, x0, np.arange(n))
    assert v == pytest.approx(1.0)
    assert x[1] == pytest.approx(1.0)


def test_local_search_large_equality_swap():
    # capped path must still find improving swaps under equality rows
    n = SWAP_FULL_LIMIT * 2
    rng = np.random.default_rng(2)
    c = rng.integers(1, 100, n).astype(float)
    Wx = np.ones((1, n))
    lo = np.concatenate([np.zeros(n), [3.0]])
    hi = np.concatenate([np.ones(n), [3.0]])  # pick exactly 3
    x0 = np.zeros(n)
    worst = np.argsort(-c)[:3]
    x0[worst] = 1.0
    x, v = local_search(Wx, c, lo, hi, x0, np.arange(n))
    assert v == pytest.approx(np.sort(c)[:3].sum())


def test_repair_fixes_one_step_bound_violation():
    """The sweep-chain case: a point feasible for every structural row but
    one unit past the new objective-bound row is repaired by a swap."""
    from moip_aira_tpu.solver.heuristics import candidate_value, repair

    # min c.x, rows: x1+x2+x3 >= 2 (cover), v.x <= 7 (objective bound)
    Wx = np.array([[1.0, 1.0, 1.0], [3.0, 4.0, 5.0]])
    c = np.array([1.0, 2.0, 3.0])
    lo = np.array([0.0, 0.0, 0.0, 2.0, -np.inf])
    hi = np.array([1.0, 1.0, 1.0, np.inf, 7.0])
    x0 = np.array([0.0, 1.0, 1.0])  # v.x = 9 > 7: violates the bound row
    assert candidate_value(Wx, c, lo, hi, x0) is None
    x = repair(Wx, c, lo, hi, x0, np.arange(3))
    assert x is not None
    v = candidate_value(Wx, c, lo, hi, x)
    assert v is not None  # feasible after repair
    assert np.array_equal(x, [1.0, 1.0, 0.0])  # the cheapest repair


def test_repair_returns_none_when_stuck():
    from moip_aira_tpu.solver.heuristics import repair

    # x1 binary, row x1 >= 2 cannot be satisfied by any unit move
    Wx = np.array([[1.0]])
    c = np.array([1.0])
    lo = np.array([0.0, 2.0])
    hi = np.array([1.0, np.inf])
    x = repair(Wx, c, lo, hi, np.array([1.0]), np.arange(1))
    assert x is None


def test_sweep_hint_rides_feeder_to_wave_incumbent():
    """End-to-end: the wave backend accepts LexRequest.x_hint and repairs it
    into a warm incumbent (observable: golden parity is kept and the hint
    path doesn't crash on either sense)."""
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.solver.wave import WaveLexBackend

    from conftest import EXAMPLES, golden_front

    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    be = WaveLexBackend(p, batch_width=16)
    front = solve_front(p, n_workers=2, backend=be)
    assert np.array_equal(front.points, golden_front("G2AP05"))


def _ap_problem():
    """3x3 assignment with two cost objectives, as (Wx, c0, c1, lo, hi)."""
    n_, N = 9, 3
    rows = np.zeros((6, n_))
    for r in range(N):
        for cc in range(N):
            rows[r, r * N + cc] = 1.0  # row sums
            rows[N + cc, r * N + cc] = 1.0  # col sums
    rng = np.random.default_rng(5)
    c0 = rng.integers(1, 9, n_).astype(float)
    c1 = rng.integers(1, 9, n_).astype(float)
    Wx = np.vstack([rows, c1[None]])  # inequality row: c1 . x
    lo = np.concatenate([np.zeros(n_), np.ones(6), [-np.inf]])
    hi = np.concatenate([np.ones(n_), np.ones(6), [np.inf]])
    return Wx, c0, c1, lo, hi, N


def test_detect_assignment_and_cycle_repair():
    from moip_aira_tpu.solver.heuristics import (
        candidate_value, cycle_improve, detect_assignment,
    )

    Wx, c0, c1, lo, hi, N = _ap_problem()
    st = detect_assignment(Wx, lo, hi)
    assert st is not None
    assert st.pair2col.shape == (N, N)
    # identity assignment; bound the c1 row to force one cycle of repair
    x0 = np.zeros(9)
    x0[[0, 4, 8]] = 1.0
    v1 = c1 @ x0
    hi2 = hi.copy()
    hi2[9 + 6] = v1 - 1  # violate by >= 1
    assert candidate_value(Wx, c0, lo, hi2, x0) is None
    x = cycle_improve(Wx, c0, lo, hi2, x0, st)
    if x is not None:  # repair can be impossible if no cheaper c1 exists
        assert candidate_value(Wx, c0, lo, hi2, x) is not None


def test_cycle_improve_polishes_to_optimum():
    """From a feasible assignment, cycle moves must reach the true optimum
    on a 3x3 instance (verified by brute force over all 6 permutations)."""
    import itertools

    from moip_aira_tpu.solver.heuristics import cycle_improve, detect_assignment

    Wx, c0, _c1, lo, hi, N = _ap_problem()
    st = detect_assignment(Wx, lo, hi)
    best = min(
        sum(c0[r * N + p[r]] for r in range(N))
        for p in itertools.permutations(range(N))
    )
    x0 = np.zeros(9)
    x0[[0, 4, 8]] = 1.0
    x = cycle_improve(Wx, c0, lo, hi, x0, st)
    assert x is not None
    assert c0 @ x == pytest.approx(best)


def test_detect_assignment_rejects_knapsack():
    from moip_aira_tpu.solver.heuristics import detect_assignment

    Wx = np.array([[3.0, 4.0, 5.0]])
    lo = np.array([0, 0, 0, -np.inf], dtype=float)
    hi = np.array([1, 1, 1, 7.0])
    assert detect_assignment(Wx, lo, hi) is None
