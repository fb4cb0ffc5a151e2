"""JAX's persistent compilation cache, placed from outside.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
other directory is set here.  Otherwise the cache goes to ``.jax_cache/``
at the repository root (listed in ``.gitignore``): a fixed path, so
later processes of the same checkout find what earlier ones compiled.
"""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache():
    """Turn the cache on; returns its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
