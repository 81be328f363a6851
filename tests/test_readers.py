"""Parser unit tests (the reference has none — SURVEY §4 notes the MOP path
is entirely untested in its CI)."""

import numpy as np
import pytest

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.sense import INF, Sense

from conftest import EXAMPLES


def test_2ap05_shapes():
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    assert p.objcnt == 2
    assert p.objsen is Sense.MIN
    assert p.n == 25
    assert p.m_struct == 10
    # all assignment rows are equalities with RHS 1
    assert np.all(p.row_lb == 1.0) and np.all(p.row_ub == 1.0)
    # binaries
    assert p.is_int.all()
    assert np.all(p.lb == 0) and np.all(p.ub == 1)
    # first coefficient of each objective (examples/G2AP05.lp: 16 X1X1, 8 X1X1)
    assert p.C[0, 0] == 16.0
    assert p.C[1, 0] == 8.0


def test_objcnt_from_last_rhs(tmp_path):
    for name, k in [("G2AP05", 2), ("G3AP05", 3), ("G3KP10", 3)]:
        p = read_problem(f"{EXAMPLES}/{name}.lp")
        assert p.objcnt == k, name
    # four objectives (the reference's 4AP05/4KP10 shapes), generated
    from moip_aira_tpu.utils.generate import ap_lp, kp_lp

    for name, text in [("4AP05", ap_lp(5, 4, seed=1)), ("4KP10", kp_lp(10, 4, seed=1))]:
        f = tmp_path / f"{name}.lp"
        f.write_text(text)
        assert read_problem(str(f)).objcnt == 4, name


def test_kp_sense_and_integer_defaults():
    p = read_problem(f"{EXAMPLES}/G3KP10.lp")
    assert p.objsen is Sense.MAX
    # `integers` section vars default to [0, 1] (CPLEX LP convention; the
    # golden fronts depend on it)
    assert p.is_int.all()
    assert np.all(p.ub == 1.0)
    assert p.row_ub[0] == 405.5 and p.row_lb[0] == -INF


def test_mop_reader():
    p = read_problem(f"{EXAMPLES}/moip_2_30_knapsack.mop")
    assert p.objcnt == 2
    assert p.objsen is Sense.MIN  # MPS default
    assert p.n == 30
    assert p.m_struct == 1  # the knapsack row; leading N rows are objectives
    assert p.row_ub[0] == 1220.0
    assert p.is_int.all()
    # explicit LO/PL bounds -> [0, +inf)
    assert np.all(p.lb == 0) and np.all(p.ub == INF)
    # first objective (OBJECTIV) coefficient of x#1 is -83
    assert p.C[0, 0] == -83.0
    assert p.C[1, 0] == -70.0  # Cost_1


def test_unknown_extension():
    with pytest.raises(ValueError):
        read_problem("problem.xyz")


def test_lp_multiline_and_senses(tmp_path):
    f = tmp_path / "t.lp"
    f.write_text(
        """\\ comment
Maximize 0
s.t.
c1: 2 x + 3 y <= 12
x +
  y >= 1
x - y = 0
4 x + y > 1
3 x + 2 y > 2
Bounds
0 <= x <= 4
y <= 9
General
x y
End
"""
    )
    p = read_problem(str(f))
    assert p.objcnt == 2
    assert p.objsen is Sense.MAX
    assert p.m_struct == 3
    assert p.row_ub[0] == 12.0
    assert p.row_lb[1] == 1.0
    assert p.row_lb[2] == 0.0 == p.row_ub[2]
    assert p.C[0].tolist() == [4.0, 1.0]
    assert p.C[1].tolist() == [3.0, 2.0]
    # bounds section overrides the integer [0,1] default
    assert p.ub.tolist() == [4.0, 9.0]
