"""XLA persistent compilation cache wiring.

Parity: the reference's pipeline cache ./out/pipeline_cache.bin
(rt_renderer.rs:229-240, 258: load-if-exists before pipeline build, save
after). Here the compiled artifact is the XLA executable, and the
equivalent mechanism is jax's persistent compilation cache directory:
enabling it makes renderer cold-start (recompile) drop from minutes to
seconds across processes.

Where `JAX_COMPILATION_CACHE_DIR` is set, jax reads it itself and this
module sets no directory; otherwise the cache lives at a fixed path in
the checkout (the path is part of the cache key, so it must not move
with the process cwd).
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger("hala_tpu.cache")

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# Anchored to the repo (two levels above this file), not the process cwd.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "out", "xla_cache",
)


def enable_compilation_cache(cache_dir: str = DEFAULT_CACHE_DIR) -> str:
    """Idempotently enable the persistent compile cache; returns the
    directory in use (`JAX_COMPILATION_CACHE_DIR` when set, else
    `cache_dir`)."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        cache_dir = env_dir
    else:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    logger.info("XLA compilation cache at %s", cache_dir)
    return cache_dir
