"""Stacked GRU with the same recurrent protocol as the LSTM.

The reference ships only an LSTM (reference: rnn.py:10-111); a GRU is the
standard lighter-state alternative (one [N, L, H] buffer instead of two —
half the recurrent-state memory and sim<->policy reorder traffic, ~25% fewer
recurrent FLOPs). Drop-in for ``LSTM`` anywhere a backbone takes an ``rnn``:
same ``init_recurrent_state`` / ``clear_recurrent_state`` / ``__call__`` /
``sequence`` surface, same batch-leading state layout and step-then-reset
done-mask ordering.

Gates are packed ``[r | z | n]`` with separate input/recurrent kernels, so
the sequence pass hoists each layer's input projection out of the BPTT scan
as ONE whole-sequence matmul. The single-step and sequence paths both run
``gru_step`` (fp32 gate math from storage-dtype operands), so they agree
bit for bit. Gate equations follow the linear-before-reset GRU cell:

    r = sigmoid(x_r + h @ W_hr);  z = sigmoid(x_z + h @ W_hz)
    n = tanh(x_n + r * (h @ W_hn + b_hn));  h' = (1 - z) * n + z * h
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .. import nn

__all__ = ["GRU", "gru_step", "gru_sequence"]


def gru_step(x_proj, h, wh, bias_h):
    """One GRU step from the projected input ``x_proj`` [N, 3H]; returns
    the new h in the storage dtype of ``x_proj``."""
    f32 = jnp.float32
    H = h.shape[-1]
    hp = jnp.dot(h.astype(wh.dtype), wh, preferred_element_type=f32)
    xp = x_proj.astype(f32)
    hn_lin = hp[..., 2 * H:] + bias_h.astype(f32)
    r = jax.nn.sigmoid(xp[..., :H] + hp[..., :H])
    z = jax.nn.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
    n = jnp.tanh(xp[..., 2 * H:] + r * hn_lin)
    return ((1.0 - z) * n + z * h.astype(f32)).astype(x_proj.dtype)


def gru_sequence(x_proj, ends, wh, bias_h, h0, unroll=1):
    """[T, N, 3H] projected inputs -> [T, N, H] outputs, clearing the
    state after every step whose ``ends`` [T, N, 1] flag is set."""

    def step(h, inputs):
        xp, end = inputs
        h = gru_step(xp, h, wh, bias_h)
        return jnp.where(end, jnp.zeros((), h.dtype), h), h

    _, ys = lax.scan(step, h0, (x_proj, ends), unroll=unroll)
    return ys


class _PackedGRULayer(nn.Module):
    """One GRU layer, gates packed [r|z|n]; input/recurrent kernels split
    so the sequence pass can hoist the input half out of the scan."""

    hidden: int
    dtype: jnp.dtype

    def _orthogonal_3h(self, key, shape, param_dtype=jnp.float32):
        # Per-gate orthogonal blocks, matching flax GRUCell's per-dense
        # orthogonal init.
        init = jax.nn.initializers.orthogonal()
        cols = shape[-1] // 3
        keys = jax.random.split(key, 3)
        blocks = [init(k, (shape[0], cols), param_dtype) for k in keys]
        return jnp.concatenate(blocks, axis=-1)

    def setup(self):
        H = self.hidden
        # Input projection as a lazily-shaped Dense (feature count is only
        # known at first call); recurrent kernel + candidate-gate recurrent
        # bias declared here (flax GRUCell's r/z recurrent denses have no
        # bias).
        self.input_proj = nn.Dense(
            3 * H, use_bias=True, kernel_init=self._orthogonal_3h,
            dtype=self.dtype, name="input_proj")
        self.recurrent_kernel = self.param(
            "recurrent_kernel", self._orthogonal_3h, (H, 3 * H))
        self.bias_h = self.param(
            "bias_h", jax.nn.initializers.zeros, (H,))

    def weights(self):
        """(recurrent kernel, candidate-gate recurrent bias) in the compute
        dtype."""
        return (self.recurrent_kernel.astype(self.dtype),
                self.bias_h.astype(self.dtype))

    def __call__(self, h, x):
        new_h = gru_step(self.input_proj(x), h, *self.weights())
        return new_h, new_h


class GRU(nn.Module):
    num_hidden_channels: int
    num_layers: int
    dtype: jnp.dtype
    # See LSTM.seq_unroll.
    seq_unroll: int = 1

    def init_recurrent_state(self, N):
        shape = (N, self.num_layers, self.num_hidden_channels)
        return jnp.zeros(shape, self.dtype)

    def clear_recurrent_state(self, rnn_states, should_clear):
        # should_clear: [N, 1]; broadcasts over (layer, hidden).
        mask = should_clear[..., None]
        return jnp.where(mask, jnp.zeros((), rnn_states.dtype), rnn_states)

    def setup(self):
        self.cells = [
            _PackedGRULayer(hidden=self.num_hidden_channels,
                            dtype=self.dtype, name=f"layer_{layer}")
            for layer in range(self.num_layers)
        ]

    def __call__(self, cur_hiddens, in_features, train):
        hs, outs = [], []
        layer_in = in_features
        for layer, cell in enumerate(self.cells):
            h, out = cell(cur_hiddens[:, layer], layer_in)
            layer_in = out
            hs.append(h)
            outs.append(out)
        return jnp.concatenate(outs, axis=-1), jnp.stack(hs, axis=1)

    def sequence(self, start_hiddens, seq_ends, seq_x, train):
        """[T, N, F] features -> [T, N, L*H] outputs, clearing state after
        any step whose ``seq_ends`` [T, N, 1] flag is set (episode
        boundary). Layer-by-layer: each layer's input projection runs as
        ONE whole-sequence matmul before its time scan."""
        outs = []
        layer_in = seq_x
        for layer, cell in enumerate(self.cells):
            ys = gru_sequence(
                cell.input_proj(layer_in), seq_ends, *cell.weights(),
                start_hiddens[:, layer], unroll=self.seq_unroll)
            layer_in = ys
            outs.append(ys)

        return jnp.concatenate(outs, axis=-1)
