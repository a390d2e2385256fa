"""Persistent XLA compilation cache for CLI sessions and scripts.

A fresh query session on an already-seen index shape pays the full XLA
compile unless the persistent cache is on; with it, the executable
reloads from disk.  The CLI, bench.py, chip_smoke.py and benchmarks/
call `enable_persistent_cache()` at startup.

Where the cache lives: JAX itself reads `JAX_COMPILATION_CACHE_DIR`, so
when that is set nothing here overrides it.  Otherwise the cache goes to
`<checkout>/.jax_cache` (gitignored): a fixed path, because the path is
part of the cache key.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_persistent_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return cache_dir()
