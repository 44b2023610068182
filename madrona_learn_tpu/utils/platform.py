"""Platform-dependent defaults shared by the entry-point scripts.

- ``compute_dtype``: the precision a script trains in.
- ``use_checkout_compile_cache``: where JAX keeps its persistent compile
  cache.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = ["CHECKOUT_CACHE_DIR", "compute_dtype", "use_checkout_compile_cache"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compute_dtype(model_dtype=jnp.bfloat16):
    """The model's compute dtype on an accelerator; float32 on the CPU,
    where runs are smoke tests and bf16 matmuls are slow."""
    return jnp.float32 if jax.default_backend() == "cpu" else model_dtype


def use_checkout_compile_cache():
    """Keep JAX's persistent compile cache in ``.jax_cache/`` at the root
    of the checkout, unless ``JAX_COMPILATION_CACHE_DIR`` is set: JAX then
    reads that variable itself and no path is set here. Returns the path
    set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
