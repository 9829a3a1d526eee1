"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache goes to one fixed directory inside
the checkout (``<checkout>/.jax_cache``, listed in ``.gitignore``): the
path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
    return CHECKOUT_DIR
