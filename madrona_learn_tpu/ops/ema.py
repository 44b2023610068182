"""Bias-corrected EMA statistics, fully on-device.

Semantics match the reference normalizers (reference: moving_avg.py:7-181):

- ``EMAEstimate``: EMA of a scalar mean with the ``-1/expm1(N log d)`` bias
  correction (equivalent to dividing by ``1 - d^N``).
- ``EMANormalizer``: EMA of per-feature mean/variance used for observation and
  value normalization. Batches are first reduced to a (mean, var) pair with a
  weighted streaming merge (Chan's parallel-variance update, generalized per
  Schubert & Gertz 2018), then folded into the EMA. All estimates are float32
  regardless of the data dtype; ``normalize``/``invert`` cast to the requested
  compute dtypes.

Everything here is a pure function over FrozenDict state pytrees so the whole
thing lives inside the jitted train step and shards trivially: the per-batch
reduction is a (possibly sharded) mean/var whose cross-device combine XLA
implements with a psum when the batch axis is sharded over the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

from jax import lax
import jax.numpy as jnp

from ..struct import FrozenDict


def _as_float(x):
    if jnp.issubdtype(x.dtype, jnp.floating):
        return x
    return x.astype(jnp.float32)


def _bias_correction(n, decay):
    # 1 / (1 - decay^n), computed stably in log space.
    return -1.0 / jnp.expm1(n.astype(jnp.float32) * jnp.log(jnp.float32(decay)))


@dataclass(frozen=True)
class EMAEstimate:
    """Bias-corrected EMA of a (vector of) scalar mean(s).

    Used for the max-advantage estimate in advantage filtering
    (reference: moving_avg.py:7-45, ppo.py:374-406).
    """

    decay: float
    eps: float = 1e-5

    def init_estimates(self, x):
        dim = x.shape[-1]
        return FrozenDict(
            mu=jnp.zeros((dim,), jnp.float32),
            mu_biased=jnp.zeros((dim,), jnp.float32),
            N=jnp.zeros((), jnp.int32),
        )

    def update_estimates(self, est, x):
        x_mean = jnp.mean(x, dtype=jnp.float32)
        alpha = jnp.float32(1) - jnp.float32(self.decay)

        new_n = est["N"] + 1
        new_mu_biased = jnp.float32(self.decay) * est["mu_biased"] + alpha * x_mean
        new_mu = new_mu_biased * _bias_correction(new_n, self.decay)

        return FrozenDict(mu=new_mu, mu_biased=new_mu_biased, N=new_n)


@dataclass(frozen=True)
class EMANormalizer:
    """EMA mean/sigma normalizer for values and observations.

    ``norm_dtype`` is the dtype normalized outputs are cast to (the network
    compute dtype); ``invert`` outputs ``inv_dtype`` (float32 for value
    de-normalization in GAE).
    """

    decay: float
    norm_dtype: jnp.dtype
    inv_dtype: jnp.dtype
    eps: float = 1e-5
    disable: bool = False

    # -- estimate state ------------------------------------------------------

    def init_estimates(self, x):
        if self.disable:
            return {}
        dim = x.shape[-1]
        # mu=0 / sigma=1 act as a no-op until the first update overwrites them
        # from the biased accumulators.
        return FrozenDict(
            mu=jnp.zeros((dim,), jnp.float32),
            inv_sigma=jnp.ones((dim,), jnp.float32),
            sigma=jnp.ones((dim,), jnp.float32),
            mu_biased=jnp.zeros((dim,), jnp.float32),
            sigma_sq_biased=jnp.zeros((dim,), jnp.float32),
            N=jnp.zeros((), jnp.int32),
        )

    # -- normalize / invert --------------------------------------------------

    def normalize(self, est, x):
        if self.disable:
            return x
        x = _as_float(x)
        out = (x - est["mu"].astype(x.dtype)) * est["inv_sigma"].astype(x.dtype)
        return out.astype(self.norm_dtype)

    def invert(self, est, x):
        if self.disable:
            return x
        x = _as_float(x)
        return (
            x.astype(self.inv_dtype) * est["sigma"].astype(self.inv_dtype)
            + est["mu"].astype(self.inv_dtype)
        )

    # -- streaming input statistics -----------------------------------------

    def init_input_stats(self, est):
        if self.disable:
            return {}
        return jnp.zeros_like(est["mu"]), jnp.zeros_like(est["mu"])

    def update_input_stats(self, cur_stats, num_prev_updates, x,
                           axis_name=None, mask=None):
        """Merge one batch of data into running (mean, var) accumulators.

        Each prior update and the new batch get equal weight, so after k calls
        the accumulators hold the mean/var of the union of all k batches
        (assuming equal batch sizes), per Chan's parallel update.

        With ``axis_name`` (inside a shard_map region where ``x`` is this
        shard's equal-sized slice of the batch), the batch moments are the
        exact global ones: mean of shard means, and the grouped variance
        ``pmean(local_var + (local_mean - global_mean)^2)``.

        With ``mask`` (broadcastable to ``x``; 1 = real, 0 = padding, used
        when a minibatch does not divide over the mesh row shards so shard
        slices are zero-padded), the batch moments count only real
        elements, via (p)summed sums and counts — equal to the unpadded
        single-device result.
        """
        if self.disable:
            return {}

        a_mean, a_var = cur_stats
        x = _as_float(x)
        reduce_axes = tuple(range(x.ndim - 1))

        if mask is not None:
            mask_f = jnp.broadcast_to(mask, x.shape).astype(jnp.float32)
            num = jnp.sum(mask_f * x, axis=reduce_axes, dtype=jnp.float32)
            cnt = jnp.sum(mask_f, axis=reduce_axes, dtype=jnp.float32)
            if axis_name is not None:
                num = lax.psum(num, axis_name)
                cnt = lax.psum(cnt, axis_name)
            b_mean = num / jnp.maximum(cnt, 1.0)
            sq = jnp.sum(mask_f * jnp.square(x - b_mean), axis=reduce_axes,
                         dtype=jnp.float32)
            if axis_name is not None:
                sq = lax.psum(sq, axis_name)
            b_var = sq / jnp.maximum(cnt, 1.0)
        elif axis_name is None:
            b_mean = jnp.mean(x, axis=reduce_axes, dtype=jnp.float32)
            b_var = jnp.mean(
                jnp.square(x - b_mean), axis=reduce_axes, dtype=jnp.float32)
        else:
            b_mean = jnp.mean(x, axis=reduce_axes, dtype=jnp.float32)
            b_mean = lax.pmean(b_mean, axis_name)
            b_var = lax.pmean(
                jnp.mean(jnp.square(x - b_mean), axis=reduce_axes,
                         dtype=jnp.float32),
                axis_name)

        delta = b_mean - a_mean
        b_weight = jnp.reciprocal(jnp.float32(num_prev_updates + 1))
        a_weight = jnp.float32(1) - b_weight

        ab_mean = a_mean + delta * b_weight
        ab_var = (
            a_weight * a_var
            + b_weight * b_var
            + jnp.square(delta) * a_weight * b_weight
        )
        return ab_mean, ab_var

    # -- EMA merge -----------------------------------------------------------

    def update_estimates(self, est, input_stats):
        """Fold one (mean, var) summary into the EMA estimates.

        The cross-term on the variance follows the arbitrary-weight
        generalization of Chan's algorithm (Schubert & Gertz 2018): the sum of
        squared deviations can be rescaled by the decay because weight changes
        in the mean cancel.
        """
        if self.disable:
            return {}

        x_mean, x_var = input_stats
        one_minus_alpha = jnp.float32(self.decay)
        alpha = jnp.float32(1) - one_minus_alpha

        mean_delta = x_mean - est["mu"]
        new_n = est["N"] + 1

        new_mu_biased = one_minus_alpha * est["mu_biased"] + alpha * x_mean
        new_sigma_sq_biased = (
            one_minus_alpha * est["sigma_sq_biased"]
            + alpha * x_var
            + (est["N"].astype(jnp.float32) / new_n.astype(jnp.float32))
            * (one_minus_alpha * alpha)
            * jnp.square(mean_delta)
        )

        correction = _bias_correction(new_n, self.decay)
        new_mu = new_mu_biased * correction
        new_sigma_sq = new_sigma_sq_biased * correction

        new_inv_sigma = lax.rsqrt(lax.max(new_sigma_sq, jnp.float32(self.eps)))
        new_sigma = jnp.reciprocal(new_inv_sigma)

        return FrozenDict(
            mu=new_mu,
            inv_sigma=new_inv_sigma,
            sigma=new_sigma,
            mu_biased=new_mu_biased,
            sigma_sq_biased=new_sigma_sq_biased,
            N=new_n,
        )

    def normalize_and_update_estimates(self, est, inputs, axis_name=None,
                                       mask=None):
        if self.disable:
            return inputs
        stats = self.update_input_stats(
            self.init_input_stats(est), 0, inputs, axis_name=axis_name,
            mask=mask)
        est = self.update_estimates(est, stats)
        return est, self.normalize(est, inputs)
