"""Stacked LSTM with explicit, batch-leading recurrent state.

Capability parity with the reference RNN layer (reference: rnn.py:10-111):
stacked LSTM layers whose per-layer outputs concatenate into the feature
vector, zero-init state, done-masked clearing, and a time-axis scan for the
BPTT update pass.

State layout: the (c, h) state is a pair of ``[N, num_layers, H]`` arrays
— the agent batch leads, so the sim<->policy reorder gathers and the
``data``-axis mesh sharding act on axis 0 of exactly two contiguous
buffers.

Sequence pass (the PPO update's dominant cost): layers scan one after
another, and each layer's *input* projection for the whole sequence is
hoisted out of the scan into a single ``[T*N, F] x [F, 4H]`` matmul — the
classic fused-RNN restructure. The scan body keeps only the recurrent
``[N, H] x [H, 4H]`` matmul and the gate math.

Both the single-step path (rollouts) and the sequence pass run the same
``lstm_step``: gates in float32 from storage-dtype operands, state rounded
back to the storage dtype at the step boundary, so rollout and update
forwards agree bit for bit and PPO ratios start at exactly 1.
Done-masking is applied *after* each step, matching the rollout engine's
step-then-reset ordering.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .. import nn

__all__ = ["LSTM", "lstm_step", "lstm_sequence"]


def lstm_step(x_proj, c, h, wr, bias):
    """One LSTM step from the projected input ``x_proj`` [N, 4H] (gate
    order i, f, g, o). Returns (c, h) in the storage dtype of ``x_proj``."""
    f32 = jnp.float32
    dt = x_proj.dtype
    gates = (x_proj.astype(f32)
             + jnp.dot(h.astype(wr.dtype), wr, preferred_element_type=f32)
             + bias.astype(f32))
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    new_c = jax.nn.sigmoid(f) * c.astype(f32) + jax.nn.sigmoid(i) * jnp.tanh(g)
    new_h = jax.nn.sigmoid(o) * jnp.tanh(new_c)
    return new_c.astype(dt), new_h.astype(dt)


def lstm_sequence(x_proj, ends, wr, bias, c0, h0, unroll=1):
    """[T, N, 4H] projected inputs -> [T, N, H] outputs, clearing the
    state after every step whose ``ends`` [T, N, 1] flag is set."""

    def step(carry, inputs):
        xp, end = inputs
        c, h = lstm_step(xp, *carry, wr, bias)
        zero = jnp.zeros((), c.dtype)
        return (jnp.where(end, zero, c), jnp.where(end, zero, h)), h

    _, ys = lax.scan(step, (c0, h0), (x_proj, ends), unroll=unroll)
    return ys


class _PackedLSTMLayer(nn.Module):
    """One LSTM layer with packed [F, 4H] / [H, 4H] gate kernels.

    Gate order along the packed axis: (i, f, g, o). Input and recurrent
    projections are separate params so the sequence pass can hoist the
    input half out of the scan.
    """

    hidden: int
    dtype: jnp.dtype

    def _orthogonal_4h(self, key, shape, param_dtype=jnp.float32):
        # Per-gate orthogonal blocks (matching the per-gate init of the
        # standard cells) packed along the last axis.
        fan_in = shape[0]
        keys = jax.random.split(key, 4)
        blocks = [
            jax.nn.initializers.orthogonal()(k, (fan_in, self.hidden),
                                             param_dtype)
            for k in keys
        ]
        return jnp.concatenate(blocks, axis=-1)

    def setup(self):
        H = self.hidden
        # Input projection as a lazily-shaped Dense (feature count is only
        # known at first call); recurrent kernel + bias declared here.
        self.input_proj = nn.Dense(
            4 * H, use_bias=False, kernel_init=self._orthogonal_4h,
            dtype=self.dtype, name="input_proj")
        self.recurrent_kernel = self.param(
            "recurrent_kernel", self._orthogonal_4h, (H, 4 * H))
        self.bias = self.param(
            "bias", jax.nn.initializers.constant(0), (4 * H,))

    def weights(self):
        """(recurrent kernel, bias) in the compute dtype."""
        return (self.recurrent_kernel.astype(self.dtype),
                self.bias.astype(self.dtype))

    def __call__(self, carry, x):
        c, h = carry  # [N, H] each
        c, h = lstm_step(self.input_proj(x), c, h, *self.weights())
        return (c, h), h


class LSTM(nn.Module):
    num_hidden_channels: int
    num_layers: int
    dtype: jnp.dtype
    # Unroll factor for the BPTT sequence scan. 1 = plain scan.
    seq_unroll: int = 1

    def init_recurrent_state(self, N):
        shape = (N, self.num_layers, self.num_hidden_channels)
        return (jnp.zeros(shape, self.dtype), jnp.zeros(shape, self.dtype))

    def clear_recurrent_state(self, rnn_states, should_clear):
        # should_clear: [N, 1]; broadcasts over (layer, hidden).
        mask = should_clear[..., None]
        return tuple(
            jnp.where(mask, jnp.zeros((), s.dtype), s) for s in rnn_states)

    def setup(self):
        self.cells = [
            _PackedLSTMLayer(hidden=self.num_hidden_channels,
                             dtype=self.dtype, name=f"layer_{layer}")
            for layer in range(self.num_layers)
        ]

    def __call__(self, cur_hiddens, in_features, train):
        c_in, h_in = cur_hiddens

        cs, hs = [], []
        layer_in = in_features
        for layer, cell in enumerate(self.cells):
            (c, h), _ = cell((c_in[:, layer], h_in[:, layer]), layer_in)
            layer_in = h
            cs.append(c)
            hs.append(h)

        carry = (jnp.stack(cs, axis=1), jnp.stack(hs, axis=1))
        return jnp.concatenate(hs, axis=-1), carry

    def sequence(self, start_hiddens, seq_ends, seq_x, train):
        """[T, N, F] features -> [T, N, L*H] outputs, clearing state after
        any step whose ``seq_ends`` [T, N, 1] flag is set (episode
        boundary).

        Layer-by-layer scans: layer l consumes layer l-1's full output
        sequence, so each layer's input projection runs as ONE whole-
        sequence matmul before its scan."""
        c0, h0 = start_hiddens
        outs = []
        layer_in = seq_x
        for layer, cell in enumerate(self.cells):
            ys = lstm_sequence(
                cell.input_proj(layer_in), seq_ends, *cell.weights(),
                c0[:, layer], h0[:, layer], unroll=self.seq_unroll)
            layer_in = ys
            outs.append(ys)
        return jnp.concatenate(outs, axis=-1)
