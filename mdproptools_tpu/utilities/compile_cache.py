"""
The persistent XLA compilation cache, in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it. Otherwise the cache lives at the fixed
``<checkout>/.jax_cache``: a fixed path, because the path is part of the
cache key, so a temporary or per-process directory would never hit.
"""

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
