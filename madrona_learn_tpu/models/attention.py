"""Entity self-attention network (Emergent-Tool-Use style).

Capability parity with the reference entity net (reference: models.py:59-97,
451-540): per-entity-type embeddings, multi-head self-attention over the
entity axis, mean-pool, and a feed-forward residual block.

Attention runs through ``jax.nn.dot_product_attention`` (XLA's fused
attention, or cuDNN's where it applies) for both the rollout and the update
pass, so the PPO ratio starts at exactly 1.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from .common import LayerNorm


class SelfAttention(nn.Module):
    num_heads: int
    qkv_features: int
    out_features: int
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x, train=False):
        return nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads,
            qkv_features=self.qkv_features,
            out_features=self.out_features,
            dtype=self.dtype,
        )(x)


class EntitySelfAttentionNet(nn.Module):
    """Per-entity-type embed -> self-attention -> mean-pool -> FF residual.

    Expects an obs dict containing a ``self`` key ([..., F_self]) plus any
    number of entity-set keys ([..., num_entities, F_e]).
    """

    num_embed_channels: int
    num_out_channels: int
    num_heads: int
    dtype: jnp.dtype
    dense_init: Callable = jax.nn.initializers.orthogonal(scale=np.sqrt(2))
    # Per the paper each entity embedding concats the self features; redundant
    # if observations are already egocentric.
    embed_concat_self: bool = False

    @nn.compact
    def __call__(self, x_tree, train):
        def embed(name, x):
            o = nn.Dense(
                self.num_embed_channels,
                use_bias=False,
                kernel_init=self.dense_init,
                dtype=self.dtype,
                name=name,
            )(x)
            o = LayerNorm(dtype=self.dtype)(o)
            return jax.nn.leaky_relu(o)

        x_tree, x_self = x_tree.pop("self")
        x_self = x_self[..., None, :]

        embedded = [embed("self_embed", x_self)]
        x_flat, _ = jax.tree_util.tree_flatten_with_path(x_tree)
        for keypath, x_entities in x_flat:
            if self.embed_concat_self:
                tile_shape = (
                    [1] * (x_entities.ndim - 2) + [x_entities.shape[-2], 1])
                x_entities = jnp.concatenate(
                    [x_entities, jnp.tile(x_self, tile_shape)], axis=-1)
            embedded.append(embed(keypath[-1].key + "_embed", x_entities))

        entities = jnp.concatenate(embedded, axis=-2)

        attended = SelfAttention(
            num_heads=self.num_heads,
            qkv_features=self.num_embed_channels,
            out_features=self.num_out_channels,
            dtype=self.dtype,
        )(entities, train=train)

        if self.num_embed_channels != self.num_out_channels:
            attended = attended + jnp.tile(
                entities, self.num_out_channels // self.num_embed_channels)
        else:
            attended = attended + entities

        pooled = attended.mean(axis=-2)
        pooled = LayerNorm(dtype=self.dtype)(pooled)

        ff = nn.Dense(
            self.num_out_channels,
            use_bias=False,
            dtype=self.dtype,
            kernel_init=self.dense_init,
            name="ff_0",
        )(pooled)
        ff = LayerNorm(dtype=self.dtype)(ff)
        ff = jax.nn.leaky_relu(ff)
        ff = nn.Dense(
            self.num_out_channels,
            use_bias=False,
            dtype=self.dtype,
            kernel_init=self.dense_init,
            name="ff_1",
        )(ff)
        ff = jax.nn.leaky_relu(ff)

        out = pooled + ff
        return LayerNorm(dtype=self.dtype)(out)
