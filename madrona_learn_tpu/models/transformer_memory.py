"""Windowed-attention memory: a transformer-style drop-in for the LSTM.

An extension beyond the reference's model zoo (its only temporal memory is
the LSTM; reference: rnn.py): recurrent state is a K/V ring buffer over the
last ``window`` steps, and each step attends its query over that window.
This trades the LSTM's sequential gate math for attention contractions
(batched matrix products), and gives the policy an explicit (inspectable)
memory horizon.

Implements the same recurrent-module protocol the backbone towers consume
(init_recurrent_state / clear_recurrent_state / __call__ / sequence), so it
plugs into ``RecurrentBackboneEncoder`` wherever an ``LSTM`` would go.

State (all batch-leading, so sim<->policy gathers and data-axis sharding act
on axis 0):
- ``k_cache``/``v_cache``: [N, window, H]
- ``age``: [N, window] int32; 0 = empty slot (cleared on done), else steps
  since written + 1.
- ``pos``: [N, 1] int32 next write slot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .. import nn

__all__ = ["WindowAttentionMemory"]


class _AttentionStep(nn.Module):
    """One memory step: project, write ring slot, attend over the window."""

    hidden: int
    heads: int
    window: int
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, carry, x):
        k_cache, v_cache, age, pos = carry
        N = x.shape[0]
        H, W = self.hidden, self.window
        head_dim = H // self.heads

        dense = lambda name: nn.Dense(
            H, use_bias=False, dtype=self.dtype,
            kernel_init=jax.nn.initializers.orthogonal(), name=name)

        q = dense("q")(x)
        k = dense("k")(x)
        v = dense("v")(x)

        # Write this step's K/V into the ring slot, age the rest.
        slot = pos[:, 0] % W
        one_hot = (
            jnp.arange(W, dtype=jnp.int32)[None, :] == slot[:, None])
        k_cache = jnp.where(one_hot[..., None], k[:, None, :], k_cache)
        v_cache = jnp.where(one_hot[..., None], v[:, None, :], v_cache)
        age = jnp.where(one_hot, 1, jnp.where(age > 0, age + 1, 0))

        # Multi-head attention of q over the (masked) window.
        def split(t, axis_n):
            return t.reshape(*t.shape[:-1], self.heads, head_dim)

        qh = split(q, N)                      # [N, heads, hd]
        kh = split(k_cache, N)                # [N, W, heads, hd]
        vh = split(v_cache, N)

        scores = jnp.einsum(
            "nhd,nwhd->nhw", qh.astype(jnp.float32),
            kh.astype(jnp.float32)) / (head_dim ** 0.5)
        scores = jnp.where(
            (age > 0)[:, None, :], scores, jnp.float32(-1e9))
        weights = jax.nn.softmax(scores, axis=-1)
        attended = jnp.einsum(
            "nhw,nwhd->nhd", weights, vh.astype(jnp.float32))
        attended = attended.reshape(N, H).astype(self.dtype)

        out = dense("out")(attended)
        with jax.numpy_dtype_promotion("standard"):
            residual = out + x
        out = nn.LayerNorm(dtype=self.dtype, name="norm")(residual)

        carry = (k_cache, v_cache, age, pos + 1)
        return carry, out


class WindowAttentionMemory(nn.Module):
    """Attention over a ring buffer of the last ``window`` steps."""

    num_hidden_channels: int
    window: int
    num_heads: int = 4
    dtype: jnp.dtype = jnp.float32

    def init_recurrent_state(self, N):
        H, W = self.num_hidden_channels, self.window
        return (
            jnp.zeros((N, W, H), self.dtype),
            jnp.zeros((N, W, H), self.dtype),
            jnp.zeros((N, W), jnp.int32),
            jnp.zeros((N, 1), jnp.int32),
        )

    def clear_recurrent_state(self, rnn_states, should_clear):
        k_cache, v_cache, age, pos = rnn_states
        clear = should_clear[:, 0].astype(jnp.bool_)
        # Emptying the age mask is sufficient (stale K/V never attends);
        # pos reset keeps behavior independent of pre-reset history length.
        age = jnp.where(clear[:, None], 0, age)
        pos = jnp.where(clear[:, None], 0, pos)
        return (k_cache, v_cache, age, pos)

    def setup(self):
        self.step = _AttentionStep(
            hidden=self.num_hidden_channels,
            heads=self.num_heads,
            window=self.window,
            dtype=self.dtype,
        )

    def __call__(self, cur_state, in_features, train):
        new_state, out = self.step(cur_state, in_features)
        return out, new_state

    def sequence(self, start_states, seq_ends, seq_x, train):
        if self.is_initializing():
            # Create the step's parameters outside the scan; inside it they
            # are read as constants.
            self.step(start_states, seq_x[0])

        def body(carry, inputs):
            x, end = inputs
            carry, y = self.step(carry, x)
            return self.clear_recurrent_state(carry, end), y

        _, outputs = lax.scan(body, start_states, (seq_x, seq_ends))
        return outputs
