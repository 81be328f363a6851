"""White-box tests of the AIRA worker state machine and bound sharing.

The golden/differential tests prove end results; these pin the *protocol*:
the reference's 2-objective "meeting" exchange (aira.cpp:679-692, 923-1107)
where partner workers walk the front from opposite ends and stop when they
cross the shared bound.
"""

import numpy as np
import pytest

from moip_aira_tpu.api import solve_front
from moip_aira_tpu.core.store import Solutions
from moip_aira_tpu.engine.scheduler import Scheduler
from moip_aira_tpu.io import read_problem
from moip_aira_tpu.parallel.cluster import build_cluster
from moip_aira_tpu.solver.lex import NumpyLexBackend

from conftest import EXAMPLES


def run_cluster(problem, n_workers, spread=True):
    be = NumpyLexBackend(problem)
    sched = Scheduler(problem, be)
    all_s = Solutions(problem.objcnt)
    infeas = Solutions(problem.objcnt)
    specs = build_cluster(n_workers, problem.objcnt, problem.objsen, spread)
    sched.run(specs, all_s, infeas)
    return sched, all_s, specs


def test_two_worker_meeting_shares_work():
    """With the synergistic exchange, two partnered workers should together
    solve FEWER subproblems than twice the serial count (each prunes the
    other's half of the walk) while still producing the full front."""
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    sched1, store1, _ = run_cluster(p, 1)
    sched2, store2, specs = run_cluster(p, 2)
    assert store1.sorted_unique_points().shape[0] == 6
    assert (store2.sorted_unique_points() == store1.sorted_unique_points()).all()
    # partners wired through shared cells
    a, b = specs
    assert a.share_to[1] is b.share_from[1]
    assert b.share_to[0] is a.share_from[0]
    # meeting must prune: the two workers together take fewer solves than
    # two independent full enumerations
    assert sched2.ip_count < 2 * sched1.ip_count


def test_shared_cells_move_monotonically():
    """share_to cells only ever tighten (reference: monotone min/max
    reduction, aira.cpp:1144-1154)."""
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    be = NumpyLexBackend(p)
    sched = Scheduler(p, be)
    specs = build_cluster(2, p.objcnt, p.objsen, True)
    a = specs[0]
    cell = a.share_to[1]
    history = []

    class SpyCell:
        def __init__(self, inner):
            self._v = inner.value

        @property
        def value(self):
            return self._v

        @value.setter
        def value(self, v):
            history.append(v)
            self._v = v

    spy = SpyCell(cell)
    # rewire both ends onto the spy
    a.share_to[1] = spy
    specs[1].share_from[1] = spy
    all_s = Solutions(p.objcnt)
    sched.run(specs, all_s, Solutions(p.objcnt))
    assert all_s.sorted_unique_points().shape[0] == 6
    assert history, "partner exchange never wrote the shared cell"
    # worker A walks objective 1 downward (MIN): published values descend
    assert all(
        history[i + 1] <= history[i] for i in range(len(history) - 1)
    ), history


def test_split_strips_cover_range_with_overlap():
    """EPP strips partition the last objective's range; the boundary unit
    overlap (split_stop widening, aira.cpp:75-79) keeps edge points
    covered."""
    from moip_aira_tpu.engine.worker_spec import WorkerSpec

    specs = []
    lohi = (24.0, 55.0)
    step = (lohi[0] - lohi[1]) / 4  # MIN: walk downward
    s0 = lohi[1]
    for t in range(4):
        specs.append(WorkerSpec.for_split(t, 2, 2, s0, s0 + step))
        s0 += step
    # strips tile [24, 55] downward
    assert specs[0].split_start == 55.0
    assert specs[-1].split_start + step == pytest.approx(24.0)


def test_worker_skips_solves_via_relaxation_store():
    """The relaxation store must answer repeated queries without new solves
    (reference solutions.cpp find-before-solve, aira.cpp:816-827)."""
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    sched, store, _ = run_cluster(p, 1)
    # the golden's own footer records 16 solves for G2AP05; relaxation
    # reuse plus deterministic tie-breaking should do no worse
    assert sched.ip_count <= 16
