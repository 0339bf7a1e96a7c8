"""Where JAX's persistent compile cache lives.

The entry points (the CLI, ``chip_smoke.py``, ``bench.py``,
``bench_configs.py``) call :func:`place_compile_cache` once, before their
first compile.  A set ``JAX_COMPILATION_CACHE_DIR`` is JAX's own setting
and wins: no code sets a directory then.  Otherwise the cache goes in
``.jax_cache`` at the root of the checkout, a fixed path, so a later run
from the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> str:
    """The directory that holds the ``alacjax`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def place_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at its directory and return
    that directory (None where the cache is switched off, as in the
    test tier)."""
    import jax
    if not jax.config.jax_enable_compilation_cache:
        return None
    env = os.environ.get(ENV)
    if env:
        return env
    path = os.path.join(checkout_root(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
