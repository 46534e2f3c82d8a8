"""JAX persistent compilation cache for the entry-point scripts.

Called by `chip_smoke.py`, `bench.py`, `examples/*.py` and the
`benchmarks` harnesses — never at package import, so the test suite
compiles as it always did.  The directory is fixed: the cache key
includes nothing about where the cache lives, but a directory that moves
from run to run is never hit again.
"""
from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it by itself and this
    sets nothing.  Otherwise the cache goes to `<repo>/.jax_cache`
    (listed in .gitignore).
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
