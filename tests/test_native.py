"""Native C++ store vs NumPy store equivalence tests."""

import numpy as np
import pytest

from moip_aira_tpu.core.store import Solutions
from moip_aira_tpu.native import load_native, NativeSolutions
from moip_aira_tpu.sense import INF, Sense

pytestmark = pytest.mark.skipif(
    load_native() is None, reason="native library not built"
)


def random_store_pair(seed, k=3, n=60):
    rng = np.random.default_rng(seed)
    a = Solutions(k)
    b = NativeSolutions(k)
    for _ in range(n):
        ip = np.where(rng.random(k) < 0.3, INF, rng.integers(0, 50, k)).astype(float)
        if rng.random() < 0.25:
            a.insert(ip, None, True)
            b.insert(ip, None, True)
        else:
            r = rng.integers(0, 40, k)
            a.insert(ip, r, False)
            b.insert(ip, r, False)
    return rng, a, b


@pytest.mark.parametrize("seed", range(5))
def test_find_equivalence(seed):
    rng, a, b = random_store_pair(seed)
    for sense in (Sense.MIN, Sense.MAX):
        for _ in range(100):
            q = np.where(rng.random(3) < 0.3, INF, rng.integers(0, 50, 3)).astype(float)
            ra = a.find(q, sense)
            rb = b.find(q, sense)
            assert (ra is None) == (rb is None)
            if ra is not None:
                assert ra.infeasible == rb.infeasible
                if not ra.infeasible:
                    # any valid relaxation yields the same optimum vector
                    assert (ra.result == rb.result).all()


@pytest.mark.parametrize("seed", range(3))
def test_find_batch_equivalence(seed):
    rng, a, b = random_store_pair(seed)
    qs = np.where(rng.random((64, 3)) < 0.3, INF, rng.integers(0, 50, (64, 3))).astype(float)
    ha, ia, ra = a.find_batch(qs, Sense.MIN)
    hb, ib, rb = b.find_batch(qs, Sense.MIN)
    assert (ha == hb).all()
    assert (ia[ha] == ib[hb]).all()
    feas = ha & ~ia
    assert (ra[feas] == rb[feas]).all()


def test_sorted_unique_equivalence():
    _, a, b = random_store_pair(42)
    assert (a.sorted_unique_points() == b.sorted_unique_points()).all()


def test_merge():
    _, a, b = random_store_pair(1)
    _, a2, b2 = random_store_pair(2)
    a.merge(a2)
    b.merge(b2)
    assert len(a) == len(b)
    assert (a.sorted_unique_points() == b.sorted_unique_points()).all()


def test_engine_with_native_store():
    """The serial AIRA engine produces the golden front with the C++ store."""
    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.io import read_problem

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    import moip_aira_tpu.engine.worker as worker_mod

    front = solve_front(p, n_workers=1, backend="numpy")
    assert front.solution_count == 6
