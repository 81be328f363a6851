"""Exactness of the combinatorial assignment engine (solver/ap_bb.py).

Three contracts (mirroring tests/test_kp_bb.py for the knapsack twin):
  * detection accepts exactly the assignment family (square bipartite
    equality structure over binary vars, integer objectives) and rejects
    knapsack rows, non-square structures, and extra inequality rows;
  * random-instance differential: the apbb front equals the brute-force
    front (small N) and the exact LP-based numpy front (larger N), across
    MIN and the mirrored MAX form; single boxed IPs equal the exact
    LP-based MIP solver under both permutations;
  * golden: the true reference AP instances reproduce their bundled
    fronts through the engine and through the production auto-routing.
"""

import numpy as np
import pytest

from moip_aira_tpu.api import make_backend, solve_front
from moip_aira_tpu.io import read_problem
from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense
from moip_aira_tpu.solver.ap_bb import (
    APLexBackend,
    detect_ap_family,
)
from moip_aira_tpu.solver.lex import LexRequest, NumpyLexBackend

from test_differential import brute_force_front

from conftest import EXAMPLES as REF


def random_ap(seed: int, N: int, k: int = 2, mirror: bool = False) -> Problem:
    rng = np.random.default_rng(seed)
    n = N * N
    A = np.zeros((2 * N, n))
    for a in range(N):
        for b in range(N):
            A[a, a * N + b] = 1.0
            A[N + b, a * N + b] = 1.0
    C = rng.integers(0, 20, size=(k, n)).astype(float)
    if mirror:
        C = -C
    return Problem(
        objcnt=k,
        objsen=Sense.MAX if mirror else Sense.MIN,
        var_names=[f"x{i}" for i in range(n)],
        C=C,
        A=A,
        row_lb=np.ones(2 * N),
        row_ub=np.ones(2 * N),
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.ones(n, dtype=bool),
        filename=f"rap-{seed}-{N}{'-mirror' if mirror else ''}",
    )


def golden(name: str) -> np.ndarray:
    rows = []
    with open(f"{REF}/{name}.out") as fh:
        for line in fh:
            t = line.split()
            if t and all(x.lstrip("-").isdigit() for x in t):
                rows.append([int(x) for x in t])
    return np.asarray(rows, dtype=np.int64)


# ---------------------------------------------------------------- detection
def test_detects_reference_ap():
    p = read_problem(f"{REF}/G2AP05.lp")
    fam = detect_ap_family(p)
    assert fam is not None
    assert fam.N == 5 and not fam.mirror
    assert make_backend(p, "auto").name == "apbb"


def test_rejects_knapsack_family():
    p = read_problem(f"{REF}/KP2D50.lp")
    assert detect_ap_family(p) is None


def test_rejects_non_square():
    p = random_ap(0, 4)
    # drop one side-B row: columns are no longer 2-regular
    q = Problem(
        objcnt=p.objcnt, objsen=p.objsen, var_names=p.var_names,
        C=p.C, A=p.A[:-1], row_lb=p.row_lb[:-1], row_ub=p.row_ub[:-1],
        lb=p.lb, ub=p.ub, is_int=p.is_int, filename="nonsq",
    )
    assert detect_ap_family(q) is None


def test_rejects_extra_inequality_row():
    p = random_ap(0, 4)
    extra = np.ones((1, p.n))
    q = Problem(
        objcnt=p.objcnt, objsen=p.objsen, var_names=p.var_names,
        C=p.C, A=np.vstack([p.A, extra]),
        row_lb=np.concatenate([p.row_lb, [-INF]]),
        row_ub=np.concatenate([p.row_ub, [3.0]]),
        lb=p.lb, ub=p.ub, is_int=p.is_int, filename="extra-row",
    )
    assert detect_ap_family(q) is None


# ------------------------------------------------------------- differential
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("mirror", [False, True])
def test_front_matches_brute_force(seed, mirror):
    p = random_ap(seed, N=3, mirror=mirror)
    fam = detect_ap_family(p)
    assert fam is not None and fam.mirror == mirror
    res = solve_front(p, n_workers=2, backend="apbb", dp="off")
    expected = brute_force_front(p)
    assert res.points.shape == expected.shape
    assert (res.points == expected).all()


@pytest.mark.parametrize("seed", range(4))
def test_front_matches_numpy_n6(seed):
    """N=6 (36 vars) is past brute force: differential vs the exact
    LP-based numpy engine instead."""
    p = random_ap(400 + seed, N=6)
    a = solve_front(p, n_workers=2, backend="apbb", dp="off")
    b = solve_front(p, n_workers=2, backend="numpy", dp="off")
    assert a.points.shape == b.points.shape
    assert (a.points == b.points).all()


@pytest.mark.parametrize("seed", range(3))
def test_three_objective_front(seed):
    p = random_ap(100 + seed, N=3, k=3)
    res = solve_front(p, n_workers=2, backend="apbb", dp="off")
    expected = brute_force_front(p)
    assert res.points.shape == expected.shape
    assert (res.points == expected).all()


@pytest.mark.parametrize("seed", range(6))
def test_single_ip_matches_lp_mip(seed):
    """One lex solve (with tight boxes) vs the exact LP-based backend."""
    p = random_ap(200 + seed, N=5)
    ap = APLexBackend(p)
    ref = NumpyLexBackend(p)
    r0 = ap.lex_solve(LexRequest(rhs=p.initial_rhs(), perm=[0, 1]))
    assert r0.status == 0
    # box objective 1 midway between its lex-min partner value and its own
    # minimum, forcing a binding side row in stage 1
    r1 = ap.lex_solve(LexRequest(rhs=p.initial_rhs(), perm=[1, 0]))
    mid = (int(r0.result[1]) + int(r1.result[1])) // 2
    rhs = p.initial_rhs()
    rhs[1] = float(mid)
    for perm in ([0, 1], [1, 0]):
        a = ap.lex_solve(LexRequest(rhs=rhs, perm=perm))
        b = ref.lex_solve(LexRequest(rhs=rhs, perm=perm))
        assert a.status == b.status
        if a.status == 0:
            assert (a.result == b.result).all()


def test_infeasible_box():
    p = random_ap(300, N=4)
    ap = APLexBackend(p)
    rhs = p.initial_rhs()
    rhs[1] = -1.0  # activities are nonneg: unattainable bound
    out = ap.lex_solve(LexRequest(rhs=rhs, perm=[0, 1]))
    assert out.status.is_infeasible


# ------------------------------------------------------------------- golden
@pytest.mark.parametrize("name", ["G2AP05", "G3AP05"])
def test_golden_small(name):
    p = read_problem(f"{REF}/{name}.lp")
    res = solve_front(p, n_workers=2, backend="apbb", dp="off")
    g = golden(name)
    assert res.points.shape == g.shape
    assert (res.points == g).all()


def _matching_front(p: Problem, N: int) -> np.ndarray:
    """Independent oracle: every one of the N! perfect matchings, filtered
    to the nondominated set, in the store's descending-lex order."""
    import itertools

    pts = set()
    for perm in itertools.permutations(range(N)):
        x = np.zeros(N * N)
        x[[a * N + perm[a] for a in range(N)]] = 1.0
        pts.add(tuple(np.rint(p.C @ x).astype(np.int64)))
    vals = np.array(sorted(pts), dtype=np.int64)
    sign = 1 if p.objsen is Sense.MIN else -1
    keep = [
        i for i in range(len(vals))
        if not any(
            (sign * vals[j] <= sign * vals[i]).all()
            and (sign * vals[j] < sign * vals[i]).any()
            for j in range(len(vals))
        )
    ]
    front = vals[keep]
    order = np.lexsort(tuple(front[:, i] for i in range(front.shape[1] - 1, -1, -1)))
    return front[order[::-1]]


def test_golden_4ap05_auto_routing(tmp_path):
    """A generated 4-objective 5x5 assignment (the reference's 4AP05 shape)
    routes to the assignment engine and equals the N! enumeration."""
    from moip_aira_tpu.utils.generate import ap_lp

    f = tmp_path / "4AP05.lp"
    f.write_text(ap_lp(5, 4, seed=1))
    p = read_problem(str(f))
    assert make_backend(p, "auto").name == "apbb"
    res = solve_front(p, n_workers=2, backend="auto")
    g = _matching_front(p, 5)
    assert res.points.shape == g.shape
    assert (res.points == g).all()


def _bundled(name: str) -> np.ndarray:
    rows = []
    with open(f"{REF}/{name}.out") as fh:
        for line in fh:
            t = line.split()
            if t and all(x.lstrip("-").isdigit() for x in t):
                rows.append([int(x) for x in t])
    return np.asarray(rows, dtype=np.int64)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["2AP40", "2AP60", "2AP80", "2AP100"])
def test_golden_ladder(name):
    """The bundled ladder goldens (oracle-spot-checked at generation,
    examples/<name>.verify.json) reproduce through the engine."""
    p = read_problem(f"{REF}/{name}.lp")
    res = solve_front(p, n_workers=2, backend="apbb", dp="off")
    g = _bundled(name)
    assert res.points.shape == g.shape
    assert (res.points == g).all()
