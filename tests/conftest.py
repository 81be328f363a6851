"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so the multi-device
sharding paths compile and execute without a GPU (``JAX_PLATFORMS=cpu``).
Set ``MOIP_TEST_GPU=1`` to run on the card instead: the ``gpu``-marked
tests then run, and they skip everywhere else.
"""

import os

if not os.environ.get("MOIP_TEST_GPU"):
    os.environ.setdefault(
        "XLA_FLAGS",
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
else:  # pragma: no cover
    import jax

jax.config.update("jax_enable_x64", True)

import pytest

# pin the general AIRA engine: the knapsack-DP shortcut (solver/kp_front.py)
# would otherwise absorb every KP-family golden test and silently drop the
# engine coverage.  DP-path tests opt back in with solve_front(dp="on").
os.environ.setdefault("MOIP_DP", "off")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the bundled instances and their golden fronts (examples/README.md)
EXAMPLES = os.path.join(REPO, "examples")


def golden_front(name: str):
    """The golden front ``examples/<name>.out`` as an (f, k) int array."""
    import numpy as np

    rows = []
    with open(os.path.join(EXAMPLES, f"{name}.out")) as fh:
        for line in fh:
            parts = line.split()
            if parts and all(p.lstrip("-").isdigit() for p in parts):
                rows.append([int(p) for p in parts])
    return np.array(rows)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running golden tests (set MOIP_RUN_SLOW=1)"
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips on any other platform "
        "(MOIP_TEST_GPU=1 python -m pytest -m gpu tests/ on the card)",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("MOIP_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow golden test; set MOIP_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with MOIP_TEST_GPU=1 on the card)")
