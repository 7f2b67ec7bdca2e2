"""Where JAX keeps its persistent compile cache.

Every entry point (the CLI, bench.py, chip_smoke.py, the test suite) calls
enable_compile_cache() before its first compilation, so all of them share
one cache that an operator can place from outside:

  - JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; nothing is set here;
  - otherwise: <checkout>/.jax_cache (listed in .gitignore), and compiles
    of 0.5 s and more are cached (JAX's own floor is 1 s; the aligner's
    many small per-shape steps fall between the two).
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
