"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench, smoke check, tests, examples): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set in code; otherwise the cache goes to ``.jax_cache`` at the repository
root. The path is part of each entry's key, so it is fixed: never made
from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=os.environ) -> str:
    """The cache directory the rule above selects."""
    return environ.get(ENV_VAR) or str(REPO_ROOT / ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir` (only when the environment
    does not already name one) and return the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
