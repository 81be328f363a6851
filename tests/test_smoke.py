"""chip_smoke.py: its phases, checked on the CPU at small sizes, and the
same phases at full size on the card (``gpu``-marked thin wrappers; they
skip wherever JAX's device is not a GPU)."""

import os
import sys

import numpy as np
import pytest

from conftest import EXAMPLES, REPO

sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


# ---- CPU: what the smoke computes, at small sizes --------------------------


def test_grid_requests_from_golden():
    front = bench.read_front(os.path.join(EXAMPLES, "G2AP05.out"))
    reqs = bench.grid_requests(front)
    assert len(reqs) == 1920
    first = [r for r in reqs[:320] if list(r.perm) == [0, 1]]
    assert len(first) == 160
    # objective-1 bounds start at the front's least objective-1 value; the
    # objective-0 caps span the front's objective-0 range
    assert min(r.rhs[1] for r in first) == front[:, 1].min()
    caps = {r.rhs[0] for r in first}
    assert np.inf in caps and max(c for c in caps if np.isfinite(c)) == front[:, 0].max()


def test_smoke_refuses_cpu(capsys):
    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("checks the refusal off the card")
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""  # no result line


def test_dp_instance_fits_budget():
    items, kp = chip_smoke.dp_instance(2**16)
    assert kp.table_cells <= 2**16
    assert items >= 4


def test_bench_grid_phase_small():
    rec = chip_smoke.phase_bench_grid(n_requests=32, batch_width=32)
    assert rec["equal_to_numpy"] and rec["lps"] > 0


def test_lp_boxes_phase_small():
    rec = chip_smoke.phase_lp_boxes(lanes=8)
    assert rec["equal_within_tolerance"]
    assert 0.0 <= rec["certified_share"] <= 1.0


def test_mesh_phase_four_cpu_devices():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs four devices")
    rec = chip_smoke.phase_mesh(4)
    assert rec["fronts_equal_golden"]
    assert len({d for d, _ in rec["wave_shards"]}) == 4


# ---- GPU: the smoke's phases at full size ----------------------------------


@pytest.mark.gpu
def test_gpu_dp(gpu):
    chip_smoke.phase_dp()


@pytest.mark.gpu
def test_gpu_bench_grid(gpu):
    chip_smoke.phase_bench_grid()


@pytest.mark.gpu
def test_gpu_lp_boxes(gpu):
    chip_smoke.phase_lp_boxes()


@pytest.mark.gpu
def test_gpu_cli_fronts(gpu):
    chip_smoke.phase_cli_fronts()


@pytest.mark.gpu
def test_gpu_wave_2ap20(gpu):
    chip_smoke.phase_wave_2ap20()


@pytest.mark.gpu
def test_gpu_monolithic(gpu):
    chip_smoke.phase_monolithic()
