"""Reduced-cost fixing must ignore lanes whose f64 certificate failed.

The verify.py contract (CertifiedBatch docstring) is that the dual rows
``d``/``at_upper``/``in_basis`` are only valid where ``ok`` held AND the
device claimed OPTIMAL; lanes re-solved by the exact host fallback keep
their *stale* cert rows.  Round-2 regression: a 2AP40 run emitted one
dominated extra point (260, 16) next to the true (259, 16) because fixing
used stale duals from a failed certificate and cut off the optimum.

These tests force the failure mode deterministically: every certificate is
declared failed and its duals poisoned with huge positive values.  With the
``_cert_fix_ok`` guard the poisoned rows are never used and the front stays
exact; without it the poisoned fixing cuts off true optima (random seeds 0
and 1 below break pre-fix).
"""

import numpy as np
import pytest

from conftest import EXAMPLES, golden_front
from test_differential import brute_force_front, random_problem


def _poison(be):
    real = be._verifier.certify

    def poisoned(c, lo, hi, status, basis, at_upper):
        cert = real(c, lo, hi, status, basis, at_upper)
        return cert._replace(
            ok=np.zeros_like(cert.ok),
            d=np.full_like(cert.d, 1e6),
            at_upper=np.zeros_like(cert.at_upper),
            in_basis=np.zeros_like(cert.in_basis),
        )

    be._verifier.certify = poisoned


def _run_front(p, be):
    from moip_aira_tpu.engine.scheduler import Scheduler
    from moip_aira_tpu.native import make_solutions
    from moip_aira_tpu.parallel.cluster import build_cluster

    sched = Scheduler(p, be)
    store = make_solutions(p.objcnt)
    infeas = make_solutions(p.objcnt)
    specs = build_cluster(1, p.objcnt, p.objsen, True)
    sched.run(specs, store, infeas)
    return sorted(map(tuple, store.sorted_unique_points()))


@pytest.mark.parametrize("seed", range(8))
def test_random_front_exact_when_all_certificates_fail(seed):
    from moip_aira_tpu.solver.wave import WaveLexBackend

    p = random_problem(seed, 2)
    want = sorted(map(tuple, brute_force_front(p)))
    be = WaveLexBackend(p, batch_width=32)
    _poison(be)
    got = _run_front(p, be)
    assert got == want, seed


def test_3kp10_front_exact_when_all_certificates_fail():
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.solver.wave import WaveLexBackend

    p = read_problem(f"{EXAMPLES}/G3KP10.lp")
    be = WaveLexBackend(p, batch_width=32)
    _poison(be)
    got = _run_front(p, be)
    assert be.verify_fallbacks > 0  # the fallback path genuinely ran
    assert got == sorted(map(tuple, golden_front("G3KP10")))
