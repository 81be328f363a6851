"""Solutions store tests — the relaxation-find dominance semantics of
reference src/solutions.cpp:17-47."""

import numpy as np

from moip_aira_tpu.core.store import Solutions
from moip_aira_tpu.sense import INF, Sense


def test_find_min_relaxation():
    s = Solutions(2)
    # solved box (ip <= [inf, 50]) with optimum (30, 40)
    s.insert([INF, 50.0], [30, 40], False)
    # query a tighter box whose bounds still contain the stored optimum
    hit = s.find(np.array([40.0, 45.0]), Sense.MIN)
    assert hit is not None and not hit.infeasible
    assert hit.result.tolist() == [30, 40]
    # box that cuts off the stored optimum -> no hit
    assert s.find(np.array([40.0, 39.0]), Sense.MIN) is None
    # box larger than the stored one -> stored is not a relaxation
    assert s.find(np.array([INF, 60.0]), Sense.MIN) is None


def test_find_infeasible_propagation():
    s = Solutions(2)
    s.insert([25.0, 40.0], None, True)  # box obj0<=25, obj1<=40 infeasible
    hit = s.find(np.array([20.0, 40.0]), Sense.MIN)  # smaller box
    assert hit is not None and hit.infeasible
    assert s.find(np.array([30.0, 40.0]), Sense.MIN) is None  # bigger box


def test_find_max_sense():
    s = Solutions(2)
    s.insert([-INF, 10.0], [50, 20], False)  # MAX: bounds are lower bounds
    hit = s.find(np.array([5.0, 15.0]), Sense.MAX)
    assert hit is not None and hit.result.tolist() == [50, 20]
    assert s.find(np.array([5.0, 25.0]), Sense.MAX) is None


def test_find_batch_matches_find():
    rng = np.random.default_rng(0)
    s = Solutions(3)
    for _ in range(40):
        ip = np.where(rng.random(3) < 0.3, INF, rng.integers(0, 50, 3))
        if rng.random() < 0.2:
            s.insert(ip, None, True)
        else:
            s.insert(ip, rng.integers(0, 40, 3), False)
    queries = np.where(
        rng.random((64, 3)) < 0.3, INF, rng.integers(0, 50, (64, 3))
    ).astype(float)
    hit, infeas, res = s.find_batch(queries, Sense.MIN)
    for i, q in enumerate(queries):
        one = s.find(q, Sense.MIN)
        assert hit[i] == (one is not None)
        if one is not None:
            assert infeas[i] == one.infeasible
            if not one.infeasible:
                assert (res[i] == one.result).all()


def test_sorted_unique_points_descending_dedup():
    s = Solutions(2)
    for r in [[3, 4], [10, 1], [3, 4], [5, 2]]:
        s.insert([INF, INF], r, False)
    s.insert([1.0, 1.0], None, True)
    pts = s.sorted_unique_points()
    assert pts.tolist() == [[10, 1], [5, 2], [3, 4]]


def test_merge():
    a, b = Solutions(2), Solutions(2)
    a.insert([INF, INF], [1, 2], False)
    b.insert([INF, INF], [3, 4], False)
    a.merge(b)
    assert len(a) == 2 and len(b) == 0


def _brute_find(s, q, sense):
    """Insertion-order linear scan — the reference semantics oracle
    (solutions.cpp:17-47) the index must agree with on HIT/MISS + kind."""
    n = len(s)
    ips = s._ips[:n]
    res = s._results[:n]
    inf = s._infeasible[:n]
    if sense is Sense.MIN:
        t1 = (ips >= q).all(axis=1)
        t3 = (res <= q).all(axis=1)
    else:
        t1 = (ips <= q).all(axis=1)
        t3 = (res >= q).all(axis=1)
    hit = t1 & (inf | t3)
    idx = np.flatnonzero(hit)
    if idx.size == 0:
        return None
    return bool(inf[idx].any()), bool((~inf[idx]).any())


def test_index_matches_bruteforce_fuzz():
    """The dominance-antichain index answers exactly like the raw scan:
    same hit/miss, and the hit kind is one the raw scan could produce.
    (Result-vector identity across different hits is guaranteed only for
    semantically consistent data — pinned by the golden/differential
    tests — so the fuzz checks hit semantics.)"""
    rng = np.random.default_rng(3)
    for k in (2, 3):
        s = Solutions(k)
        for _ in range(300):
            ip = np.where(rng.random(k) < 0.3, INF, rng.integers(0, 60, k)).astype(float)
            if rng.random() < 0.4:
                s.insert(ip, None, True)
            else:
                s.insert(ip, rng.integers(0, 50, k), False)
            if rng.random() < 0.5:
                q = np.where(
                    rng.random(k) < 0.2, INF, rng.integers(0, 60, k)
                ).astype(float)
                for sense in (Sense.MIN, Sense.MAX):
                    got = s.find(q, sense)
                    want = _brute_find(s, q, sense)
                    assert (got is None) == (want is None)
                    if got is not None:
                        had_inf, had_feas = want
                        assert (got.infeasible and had_inf) or (
                            not got.infeasible and had_feas
                        )


def test_index_sublinear_scaling():
    """Query cost must not grow linearly with
    the store.  Front-shaped data (few distinct result vectors — what AIRA
    stores actually hold): find at 64k entries must stay within 8x of find
    at 1k (the raw O(n) scan would be ~64x)."""
    import time

    def build_and_time(n):
        rng = np.random.default_rng(1)
        s = Solutions(2)
        s.insert(np.array([1e6, 1e6]), None, True)
        s.find(np.array([1e9, 1e9]), Sense.MIN)  # fix sense -> index on
        front = np.column_stack(
            [np.arange(128) * 37 % 9000, 9000 - np.arange(128) * 53 % 9000]
        )
        for i in range(n):
            r = front[i % 128]
            ip = r + rng.integers(0, 30, 2)
            if i % 2:
                s.insert(ip.astype(float) - 100, None, True)
            else:
                s.insert(ip.astype(float), r, False)
        qs = rng.integers(0, 10000, (2000, 2)).astype(float)
        t0 = time.perf_counter()
        for q in qs:
            s.find(q, Sense.MIN)
        return time.perf_counter() - t0

    t_small = build_and_time(1000)
    t_big = build_and_time(64000)
    assert t_big < 8 * t_small + 0.05, (t_small, t_big)
