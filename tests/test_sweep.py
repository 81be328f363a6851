"""Adaptive parallel bound sweep (solver/sweep.py): exact-front parity with
the AIRA ladder on every bundled bi-objective instance, both senses, plus
the covering-argument edge cases.  The sweep is the k=2 front driver for
batch-parallel backends (api.solve_front sweep='auto')."""

import numpy as np
import pytest

from moip_aira_tpu.api import make_backend, solve_front
from moip_aira_tpu.io import read_problem
from moip_aira_tpu.solver.sweep import sweep_front

from conftest import EXAMPLES, golden_front


def _ladder_front(p):
    return solve_front(p, n_workers=1, backend="numpy", sweep="off").points


@pytest.mark.parametrize("name", ["G2AP05", "gen-2AP06"])
def test_sweep_matches_ladder(name, tmp_path):
    if name == "G2AP05":  # bundled instance, MIN sense
        path = f"{EXAMPLES}/G2AP05.lp"
    else:  # a generated 6x6 assignment
        from moip_aira_tpu.utils.generate import ap_lp

        path = tmp_path / "2AP06.lp"
        path.write_text(ap_lp(6, 2, seed=7))
    p = read_problem(str(path))
    be = make_backend(p, "numpy")
    sw = sweep_front(p, be, batch=16)
    assert sw is not None
    assert np.array_equal(sw.points, _ladder_front(p))
    # chained ladders keep the lex-IP overshoot bounded: ~front + chains
    assert sw.ip_count <= 2 * (2 * len(sw.points) + 16 + 2)


@pytest.mark.slow
@pytest.mark.parametrize(
    "path",
    [
        f"{EXAMPLES}/G2KP50.lp",
        f"{EXAMPLES}/KP2D50.lp",
        f"{EXAMPLES}/moip_2_30_knapsack.mop",
    ],
)
def test_sweep_matches_ladder_slow(path):
    """Bigger fronts (65/35/64 points) — minutes on the sequential numpy
    backend, so slow-tier; the wave backend runs these as full batches."""
    p = read_problem(path)
    be = make_backend(p, "numpy")
    sw = sweep_front(p, be, batch=16)
    assert sw is not None
    assert np.array_equal(sw.points, _ladder_front(p))


def test_sweep_max_sense_tiny_kp2d():
    """MAX-sense covering (2-constraint knapsack, 12 items) — fast."""
    import tempfile, os

    from moip_aira_tpu.utils.generate import kp_lp

    with tempfile.NamedTemporaryFile("w", suffix=".lp", delete=False) as fh:
        fh.write(kp_lp(12, 2, seed=3, constraints=2))
        path = fh.name
    try:
        p = read_problem(path)
        be = make_backend(p, "numpy")
        sw = sweep_front(p, be, batch=8)
        assert sw is not None
        assert np.array_equal(sw.points, _ladder_front(p))
    finally:
        os.unlink(path)


def test_sweep_small_batch_still_complete():
    """batch=2 forces many rounds but the covering stays exact."""
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    be = make_backend(p, "numpy")
    sw = sweep_front(p, be, batch=2)
    assert np.array_equal(sw.points, _ladder_front(p))


def test_sweep_declines_three_objectives():
    p = read_problem(f"{EXAMPLES}/G3AP05.lp")
    be = make_backend(p, "numpy")
    assert sweep_front(p, be) is None


def test_sweep_via_solve_front_wave_backend():
    """sweep='auto' routes wave-backend k=2 solves through the sweep and
    reproduces the golden front."""
    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    from moip_aira_tpu.solver.wave import WaveLexBackend

    be = WaveLexBackend(p, batch_width=16)
    front = solve_front(p, n_workers=2, backend=be)
    assert np.array_equal(front.points, golden_front("G2AP05"))
    # the ladder would need >= one dependent round per point, plus one
    assert front.rounds < front.solution_count


def test_sweep_single_point_front():
    """A problem whose front is one point (objectives agree)."""
    import textwrap

    lp = textwrap.dedent(
        """\
        Minimize 0
        s.t.
        x1 + x2 > 1
        2 x1 + x2 < 1
        2 x1 + x2 < 2
        BINARY
        x1
        x2
        END
        """
    )
    import tempfile, os

    with tempfile.NamedTemporaryFile(
        "w", suffix=".lp", delete=False
    ) as fh:
        fh.write(lp)
        path = fh.name
    try:
        p = read_problem(path)
        be = make_backend(p, "numpy")
        sw = sweep_front(p, be)
        assert np.array_equal(sw.points, _ladder_front(p))
    finally:
        os.unlink(path)
