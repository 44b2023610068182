"""GAE and discounted-return computation.

Capability parity with the reference advantage math (reference:
algo_common.py:45-131), re-expressed as a reverse ``lax.scan`` (the reference
uses a ``fori_loop`` with scatter writes; a scan with stacked outputs is one
XLA while loop with no scatters and shards trivially over the batch axis,
which is the only axis the recurrence does not touch).

Inputs arrive in the trajectory-store layout ``[C, T/C, P, B, 1]``
(bptt-chunks x steps x policies x agents); the recurrence runs over the full
``T = C * T/C`` time axis.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _time_major(x, T):
    return x.reshape(T, -1, 1)


def _as_float(x):
    """Return/advantage math runs in float even for integer reward/value
    dtypes (e.g. the integer-exact fake sim); float inputs pass through
    untouched so the bitwise reference parity holds."""
    if jnp.issubdtype(x.dtype, jnp.floating):
        return x
    return x.astype(jnp.float32)


def compute_returns(gamma, rewards, dones, bootstrap_values):
    """Discounted returns with done-masking; bootstrap from the final value."""
    C, TC, P, B = dones.shape[:4]
    T = C * TC

    seq_dones = _time_major(dones, T)
    seq_rewards = _as_float(_time_major(rewards, T))
    bootstrap = _as_float(bootstrap_values.reshape(-1, 1))

    def step(next_return, inputs):
        cur_dones, cur_rewards = inputs
        next_return = jnp.where(cur_dones, 0, next_return)
        cur_return = cur_rewards + gamma * next_return
        return cur_return, cur_return

    _, returns = lax.scan(
        step, bootstrap, (seq_dones, seq_rewards), reverse=True)
    return returns.reshape(C, TC, P, B, 1)


def compute_advantages(gamma, gae_lambda, rewards, values, dones,
                       bootstrap_values):
    """GAE: A_t = delta_t + gamma * lambda * A_{t+1}, masked at episode ends."""
    C, TC, P, B = dones.shape[:4]
    T = C * TC

    seq_dones = _time_major(dones, T)
    seq_rewards = _as_float(_time_major(rewards, T))
    seq_values = _as_float(_time_major(values, T))
    bootstrap = _as_float(bootstrap_values.reshape(-1, 1))

    def step(carry, inputs):
        next_advantage, next_values = carry
        cur_dones, cur_rewards, cur_values = inputs

        next_values = jnp.where(cur_dones, 0, next_values)
        next_advantage = jnp.where(cur_dones, 0, next_advantage)

        td_err = cur_rewards + gamma * next_values - cur_values
        cur_advantage = td_err + gamma * gae_lambda * next_advantage
        return (cur_advantage, cur_values), cur_advantage

    (_, _), advantages = lax.scan(
        step,
        (jnp.zeros_like(bootstrap), bootstrap),
        (seq_dones, seq_rewards, seq_values),
        reverse=True,
    )
    return advantages.reshape(C, TC, P, B, 1)


def zscore_data(data, axis_name=None, mask=None):
    """Z-score normalize in float32; variance floored at 1e-5.

    With ``axis_name`` (inside a shard_map region where ``data`` holds this
    shard's slice of the batch), the moments are the exact global ones:
    mean of equal-sized shard means, and the two-pass variance around the
    global mean — matching the single-device formula under any equal
    partitioning.

    With ``mask`` (broadcastable to ``data``; 1 = real, 0 = padding, used
    when a minibatch does not divide evenly over the mesh row shards), the
    moments count only the real elements: sums and element counts are
    (p)summed so the result equals the unpadded single-device computation.
    Padded positions come out z-scored against the real moments — callers
    zero their contribution through their own weights.
    """
    if mask is None:
        if axis_name is None:
            mean = jnp.mean(data, dtype=jnp.float32).astype(data.dtype)
            var = jnp.var(data, dtype=jnp.float32).astype(data.dtype)
        else:
            mean = lax.pmean(jnp.mean(data, dtype=jnp.float32), axis_name)
            var = lax.pmean(
                jnp.mean(jnp.square(data.astype(jnp.float32) - mean),
                         dtype=jnp.float32),
                axis_name)
            mean = mean.astype(data.dtype)
            var = var.astype(data.dtype)
    else:
        mask_f = jnp.broadcast_to(mask, data.shape).astype(jnp.float32)
        data_f = data.astype(jnp.float32)
        num = jnp.sum(mask_f * data_f)
        cnt = jnp.sum(mask_f)
        if axis_name is not None:
            num = lax.psum(num, axis_name)
            cnt = lax.psum(cnt, axis_name)
        mean = num / jnp.maximum(cnt, 1.0)
        sq = jnp.sum(mask_f * jnp.square(data_f - mean))
        if axis_name is not None:
            sq = lax.psum(sq, axis_name)
        var = sq / jnp.maximum(cnt, 1.0)
        mean = mean.astype(data.dtype)
        var = var.astype(data.dtype)
    return (data - mean) * lax.rsqrt(jnp.clip(var, 1e-5))
