"""Persistent XLA compilation cache location.

Every entry point calls `enable_compile_cache()` before its first
compile.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself
and nothing is changed here; otherwise the cache lives at
`<checkout>/.jax_cache`, a fixed path (the path is part of the cache key,
so a directory that moves never hits).
"""

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache():
    """Returns the directory JAX caches compiled programs in."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
