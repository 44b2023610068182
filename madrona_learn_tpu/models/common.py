"""Shared building-block modules: layer norm and MLP trunks.

Capability parity with the reference building blocks (reference:
models.py:46-120). ``LayerNorm`` keeps its parameters under a stable path
(``.../LayerNorm_k/impl/{scale,bias}``) because the PPO update renormalizes
those parameters by name (see ppo.py weight projection) and checkpoints
read them.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn


class LayerNorm(nn.Module):
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x):
        return nn.LayerNorm(name="impl", dtype=self.dtype)(x)


class MLP(nn.Module):
    """Dense(no-bias) -> LayerNorm -> ReLU stack with orthogonal init."""

    num_channels: int
    num_layers: int
    dtype: jnp.dtype
    weight_init: Callable = jax.nn.initializers.orthogonal(scale=np.sqrt(2))

    @nn.compact
    def __call__(self, inputs, train):
        x = inputs
        for _ in range(self.num_layers):
            x = nn.Dense(
                self.num_channels,
                use_bias=False,
                kernel_init=self.weight_init,
                dtype=self.dtype,
            )(x)
            x = LayerNorm(dtype=self.dtype)(x)
            x = jax.nn.relu(x)
        return x
