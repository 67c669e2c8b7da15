"""Persistent XLA compilation cache — cold-start compiles paid once.

XLA's persistent cache keeps compiled programs across processes, keyed by
program and topology.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and this module sets no directory.  Otherwise the cache lives at
one fixed path inside the checkout, ``<repo>/.jax_cache`` (git-ignored):
the path is part of what makes a later process hit, so it never moves.

Enabled by the CLI, ``bench.py`` and ``chip_smoke.py``.
``DEWI_COMPILE_CACHE=0`` disables it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_enabled_dir: Optional[str] = None


def enable_compilation_cache() -> Optional[str]:
    """Turn on JAX's persistent compilation cache (idempotent).

    Returns the cache directory in use, or None when disabled.  Call it
    before the first compile."""
    global _enabled_dir
    if os.environ.get("DEWI_COMPILE_CACHE", "1") == "0":
        return None
    if _enabled_dir is not None:
        return _enabled_dir
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        path = str(CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything that takes noticeable time; tiny programs
    # recompile faster than they deserialize.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled_dir = path
    return path


__all__ = ["CACHE_DIR", "enable_compilation_cache"]
