"""The one device probe and the one compile-cache setting.

``platform()`` names the platform JAX computes on: ``"gpu"`` (an NVIDIA
card, the production target) or ``"cpu"`` (the test suite's platform).
Every routing decision that depends on the device goes through it; a
failed probe or any other platform raises instead of quietly picking a
slower path.

``enable_compile_cache()`` turns on JAX's persistent compilation cache for
every entry path (CLI, ``solve_front``/``make_backend``, ``kp2_front``, the
device backends, ``chip_smoke.py``).
"""

from __future__ import annotations

import os

#: the cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a
#: fixed path inside the checkout (listed in .gitignore), so a later run of
#: the same checkout finds what an earlier one compiled
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_SUPPORTED = ("gpu", "cpu")
_cache_enabled = False


def platform() -> str:
    """Platform of JAX's default device: ``"gpu"`` or ``"cpu"``."""
    import jax

    plat = jax.devices()[0].platform
    if plat not in _SUPPORTED:
        raise RuntimeError(
            f"JAX platform {plat!r} is not supported: this program runs on an "
            "NVIDIA GPU, or on the CPU for tests (JAX_PLATFORMS=cpu)"
        )
    return plat


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent).

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads the variable itself and
    no directory is set here; otherwise the cache lives in ``CACHE_DIR``.
    """
    global _cache_enabled
    if _cache_enabled:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _cache_enabled = True
