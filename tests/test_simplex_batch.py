"""Batched exact host simplex (solver/simplex_batch.py) vs the sequential
oracle (solver/simplex_np.py): identical terminal statuses and optimal
values on random bounded LPs, warm and cold, including adversarial warm
bases.  The batch path is the round-3 audit-wall fix — every device record
whose certificate fails rigor resolves through it — so it must be bit-exact
against the court of last resort it replaces."""

import numpy as np
import pytest

from moip_aira_tpu.solver.simplex_np import SimplexWorkspace, solve_lp
from moip_aira_tpu.solver.simplex_batch import solve_lp_batch
from moip_aira_tpu.solver.status import SolveStatus


def _random_instance(rng, m=6, n=14):
    """Integer-data LP in the framework's [A|-I] bounded-variable form."""
    A = rng.integers(-4, 6, size=(m, n)).astype(np.float64)
    ws = SimplexWorkspace(A)
    return ws, A


def _random_box(rng, ws, tight=False):
    n, m = ws.n, ws.m
    lo = np.zeros(n + m)
    hi = np.zeros(n + m)
    lo[:n] = 0.0
    hi[:n] = rng.integers(1, 4, size=n).astype(np.float64)
    # row activity bounds around the feasible range; some infinite
    lo[n:] = -np.inf
    hi[n:] = rng.integers(2, 30, size=m).astype(np.float64)
    if tight:
        hi[n:] = rng.integers(-8, 6, size=m).astype(np.float64)
    for j in range(m):
        if rng.random() < 0.3:
            lo[n + j] = -float(rng.integers(0, 20))
        if rng.random() < 0.2:
            hi[n + j] = np.inf
    return lo, hi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_sequential_cold(seed):
    rng = np.random.default_rng(seed)
    ws, _ = _random_instance(rng)
    S = 48
    cs, los, his = [], [], []
    for _ in range(S):
        c = rng.integers(-9, 10, size=ws.n).astype(np.float64)
        lo, hi = _random_box(rng, ws, tight=rng.random() < 0.4)
        cs.append(c)
        los.append(lo)
        his.append(hi)
    got = solve_lp_batch(ws, np.stack(cs), np.stack(los), np.stack(his))
    for i in range(S):
        want = solve_lp(ws, cs[i], los[i], his[i])
        assert got[i].status == want.status, f"lane {i}"
        if want.status == SolveStatus.OPTIMAL:
            assert got[i].obj == pytest.approx(want.obj, abs=1e-7), f"lane {i}"
            # the returned x must be feasible and achieve obj exactly
            z = got[i].x
            acts = ws.W[:, : ws.n] @ z
            assert (z >= los[i][: ws.n] - 1e-7).all()
            assert (z <= his[i][: ws.n] + 1e-7).all()
            assert (acts >= los[i][ws.n :] - 1e-6).all()
            assert (acts <= his[i][ws.n :] + 1e-6).all()


def test_batch_warm_start_correct_and_adversarial():
    """Warm bases: a good basis must not change the answer; a garbage one
    must be rejected or survived (validated fallback), never corrupt it."""
    rng = np.random.default_rng(7)
    ws, _ = _random_instance(rng, m=5, n=10)
    S = 32
    cs, los, his = [], [], []
    for _ in range(S):
        cs.append(rng.integers(-9, 10, size=ws.n).astype(np.float64))
        lo, hi = _random_box(rng, ws)
        los.append(lo)
        his.append(hi)
    cs, los, his = np.stack(cs), np.stack(los), np.stack(his)

    # first pass cold: harvest optimal bases
    cold = solve_lp_batch(ws, cs, los, his)
    wb = np.full((S, ws.m), -1, dtype=np.int64)
    wa = np.zeros((S, ws.ncols), dtype=bool)
    for i, r in enumerate(cold):
        if r.status == SolveStatus.OPTIMAL:
            b = np.flatnonzero(r.in_basis)
            if b.size == ws.m:
                wb[i] = b
                wa[i] = r.at_upper
    # adversarial rows: random (possibly duplicate / out-of-range) bases
    for i in range(0, S, 3):
        wb[i] = rng.integers(-2, ws.ncols + 2, size=ws.m)
        wa[i] = rng.random(ws.ncols) < 0.5

    warm = solve_lp_batch(ws, cs, los, his, warm_basis=wb, warm_at_upper=wa)
    for i in range(S):
        assert warm[i].status == cold[i].status, f"lane {i}"
        if cold[i].status == SolveStatus.OPTIMAL:
            assert warm[i].obj == pytest.approx(cold[i].obj, abs=1e-7)


def test_batch_on_bundled_instance_stage_lps():
    """Stage LPs from a real bundled instance (G2AP05 + objective rows)."""
    from conftest import EXAMPLES
    from moip_aira_tpu.io import read_problem

    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    A_full = np.vstack([p.A, p.C])
    ws = SimplexWorkspace(A_full)
    rng = np.random.default_rng(3)
    S = 24
    cs = np.tile(np.asarray(p.C[0], dtype=np.float64), (S, 1))
    los = np.zeros((S, ws.ncols))
    his = np.zeros((S, ws.ncols))
    for i in range(S):
        lo = np.concatenate([p.lb, p.row_lb, [-np.inf, -np.inf]])
        hi = np.concatenate(
            [p.ub, p.row_ub, [np.inf, float(rng.integers(20, 60))]]
        )
        los[i], his[i] = lo, hi
    got = solve_lp_batch(ws, cs, los, his)
    for i in range(S):
        want = solve_lp(ws, cs[i], los[i], his[i])
        assert got[i].status == want.status
        if want.status == SolveStatus.OPTIMAL:
            assert got[i].obj == pytest.approx(want.obj, abs=1e-7)


def test_batch_empty_and_degenerate_boxes():
    rng = np.random.default_rng(11)
    ws, _ = _random_instance(rng, m=4, n=8)
    c = rng.integers(-5, 6, size=ws.n).astype(np.float64)
    lo, hi = _random_box(rng, ws)
    lo_bad = lo.copy()
    lo_bad[0] = 5.0  # > hi[0] (structural his are <= 3): empty box
    hi_fix = hi.copy()
    lo_fix = lo.copy()
    lo_fix[1] = hi_fix[1]  # fixed variable (degenerate but feasible)
    got = solve_lp_batch(
        ws,
        np.stack([c, c]),
        np.stack([lo_bad, lo_fix]),
        np.stack([hi, hi_fix]),
    )
    assert got[0].status == SolveStatus.INFEASIBLE
    want = solve_lp(ws, c, lo_fix, hi_fix)
    assert got[1].status == want.status
    if want.status == SolveStatus.OPTIMAL:
        assert got[1].obj == pytest.approx(want.obj, abs=1e-7)
