"""Golden end-to-end tests — the reference's own contract.

Mirrors Examples/CMakeLists.txt:4-28: for each instance, five configurations
(serial, 2 synergistic workers, explicit spreading, EPP uniform, EPP normal)
must all reproduce the committed golden Pareto front.  The oracle is the
front itself plus the solution count (scripts/checkResults.sh:10 ignores
timing/ipcount/banner lines).  The instances are the bundled twins of the
reference's examples (examples/README.md), each with its own golden.
"""

import pytest

from moip_aira_tpu.api import solve_front
from moip_aira_tpu.io import read_problem

from conftest import EXAMPLES, golden_front

CONFIGS = [
    ("t1", dict(n_workers=1)),
    ("t2", dict(n_workers=2)),
    ("t2-spread", dict(n_workers=2, spread=True)),
    ("t2-split", dict(n_workers=2, split=True)),
    ("t2-split-normal", dict(n_workers=2, split=True, split_normal=True)),
]

FAST = ["G2AP05", "G3AP05", "G3KP10"]
SLOW = ["G2KP50"]


def check(name: str, backend: str, **kwargs):
    ext = ".mop" if name.endswith("knapsack") else ".lp"
    p = read_problem(f"{EXAMPLES}/{name}{ext}")
    front = solve_front(p, backend=backend, **kwargs)
    expect = golden_front(name)
    assert front.points.shape == expect.shape, (
        f"{name}: got {front.points.shape[0]} points, want {expect.shape[0]}"
    )
    assert (front.points == expect).all(), f"{name}: front mismatch"


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("name", FAST)
def test_golden_fast_numpy(name, cfg_name, cfg):
    check(name, "numpy", **cfg)


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("name", FAST)
def test_golden_fast_jax(name, cfg_name, cfg):
    check(name, "jax", **cfg)


@pytest.mark.slow
@pytest.mark.parametrize("cfg_name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("name", SLOW)
def test_golden_slow_jax(name, cfg_name, cfg):
    check(name, "jax", **cfg)


@pytest.mark.slow
def test_golden_mop_jax():
    check("moip_2_30_knapsack", "jax", n_workers=1)


def test_front_counts_table():
    """Solution counts of the fast twins, from their golden footers."""
    for name, count in [("G2AP05", 6), ("G3AP05", 7), ("G3KP10", 18)]:
        p = read_problem(f"{EXAMPLES}/{name}.lp")
        front = solve_front(p, n_workers=1, backend="numpy")
        assert front.solution_count == count


# ---- wave tier: the GPU production path on the goldens -------------------
# The wave backend is what every GPU run of an off-family instance takes
# (api.make_backend 'auto'); run it through the same 5-config matrix as
# numpy/jax so the contract backend and the tested backend are the same.


def _wave_backend(name: str):
    from moip_aira_tpu.solver.wave import WaveLexBackend

    p = read_problem(f"{EXAMPLES}/{name}.lp")
    return p, WaveLexBackend(p, batch_width=8)


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("name", FAST)
def test_golden_fast_wave(name, cfg_name, cfg):
    p, be = _wave_backend(name)
    front = solve_front(p, backend=be, **cfg)
    expect = golden_front(name)
    assert front.points.shape == expect.shape, (
        f"{name}: got {front.points.shape[0]} points, want {expect.shape[0]}"
    )
    assert (front.points == expect).all(), f"{name}: front mismatch"

