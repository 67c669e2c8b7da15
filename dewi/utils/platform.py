"""Platform override for benchmark/profile entry points.

Routes ``DEWI_BENCH_PLATFORM`` (or ``JAX_PLATFORMS``) through the config
API before the backend initializes.  ``DEWI_BENCH_PLATFORM`` wins over
``JAX_PLATFORMS`` (it exists so CI can force CPU without disturbing the
test conftest's env handling).
"""

from __future__ import annotations

import os


def apply_platform_override() -> str | None:
    """Honor DEWI_BENCH_PLATFORM / JAX_PLATFORMS via jax.config.

    Must run before first backend use.  Returns the platform applied (or
    None).  Safe to call repeatedly.
    """
    plat = os.environ.get("DEWI_BENCH_PLATFORM") or os.environ.get(
        "JAX_PLATFORMS"
    )
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)
    return plat or None


__all__ = ["apply_platform_override"]
