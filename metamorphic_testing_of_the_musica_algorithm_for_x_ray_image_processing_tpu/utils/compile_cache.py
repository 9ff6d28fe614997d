"""Where JAX's persistent compile cache lives.

One rule for every entry point (``cli.main``, ``bench.py``,
``chip_smoke.py`` and the test suite): when ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing is set here; otherwise the cache goes
to ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The path is fixed
so that a later process finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Apply the rule above and return the cache directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
