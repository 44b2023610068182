"""Action and return distributions.

Capability parity with the reference distribution layer (reference:
dists.py:12-284 and the HL-Gauss classes in models.py:177-250):

- ``DiscreteActionDistributions``: multi-head categorical over one concatenated
  logits tensor (one head per action component, each with its own bucket
  count).
- ``ContinuousActionDistributions``: tanh-squashed mean, sigmoid-ranged
  stddev normal.
- ``SymExpTwoHotDistribution``: DreamerV3 two-hot symexp-binned return
  distribution.
- ``HLGaussDist`` / ``HLGaussTwoPartDist``: histogram-Gaussian ("stop
  regressing") return distributions with linear or float-spaced bins.

All log-prob/entropy math runs in float32 regardless of the network compute
dtype (bf16 logits are upcast on entry), which PPO ratio stability
requires.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
from jax import random

from ..config import ContinuousActionsConfig
from ..struct import FrozenDict, PyTreeNode, field
from ..utils.math import symexp


def _log_softmax(logits):
    # logits - logsumexp, formulated for cheap reuse during sampling.
    return logits - jax.nn.logsumexp(logits, axis=-1, keepdims=True)


def _select_along_last(x, idx):
    """``take_along_axis(x, idx, -1)`` as a one-hot multiply-reduce.

    With the small bucket counts of discrete action heads, comparing an
    iota against the index and reducing is one dense elementwise fusion
    instead of a gather. Differentiable
    in ``x`` (gradient is the one-hot mask).
    """
    k = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    return jnp.sum(jnp.where(k == idx, x, 0.0), axis=-1, keepdims=True)


class DiscreteActionDistributions(PyTreeNode):
    """Multi-head categorical distribution over concatenated logits."""

    actions_num_buckets: List[int] = field(pytree_node=False)
    all_logits: jax.Array

    def _head_logits(self):
        offset = 0
        for num_buckets in self.actions_num_buckets:
            yield self.all_logits[..., offset:offset + num_buckets].astype(
                jnp.float32)
            offset += num_buckets

    def sample(self, prng_key):
        actions, log_probs = [], []
        keys = random.split(prng_key, len(self.actions_num_buckets))
        for key, logits in zip(keys, self._head_logits()):
            action = random.categorical(key, logits)[..., None]
            head_log_probs = _select_along_last(logits, action) - \
                jax.nn.logsumexp(logits, axis=-1, keepdims=True)
            actions.append(action)
            log_probs.append(head_log_probs)
        return (jnp.concatenate(actions, axis=-1),
                jnp.concatenate(log_probs, axis=-1))

    def best(self):
        return jnp.concatenate(
            [jnp.argmax(l, axis=-1, keepdims=True) for l in self._head_logits()],
            axis=-1)

    def action_stats(self, all_actions):
        """Log-probs of stored actions + per-head entropies (for PPO update)."""
        log_probs, entropies = [], []
        for i, logits in enumerate(self._head_logits()):
            lp = _log_softmax(logits)
            # jax.nn.softmax has a custom jvp; use it rather than exp(lp).
            p_logp = jax.nn.softmax(logits) * lp
            entropies.append(-p_logp.sum(axis=-1, keepdims=True))

            action = all_actions[..., i][..., None]
            log_probs.append(_select_along_last(lp, action))
        return (jnp.concatenate(log_probs, axis=-1),
                jnp.concatenate(entropies, axis=-1))

    def probs(self):
        return [jnp.exp(_log_softmax(l)) for l in self._head_logits()]

    def logits(self):
        return list(self._head_logits())


class ContinuousActionDistributions(PyTreeNode):
    """Independent normal heads with tanh-mean, sigmoid-ranged stddev."""

    cfgs: List[ContinuousActionsConfig] = field(pytree_node=False)
    means: jax.Array
    stds: jax.Array

    def _head_params(self):
        for i, cfg in enumerate(self.cfgs):
            raw_mean = self.means[..., i:i + 1, :].astype(jnp.float32)
            raw_std = self.stds[..., i:i + 1, :].astype(jnp.float32)
            mean = jnp.tanh(raw_mean)
            std = ((cfg.stddev_max - cfg.stddev_min)
                   * jax.nn.sigmoid(raw_std + 2.0) + cfg.stddev_min)
            yield mean, std

    def sample(self, prng_key):
        actions, log_probs = [], []
        keys = random.split(prng_key, len(self.cfgs))
        for key, (mean, std) in zip(keys, self._head_params()):
            noise = random.normal(key, mean.shape, jnp.float32)
            action = mean + std * noise
            actions.append(action)
            log_probs.append(jax.scipy.stats.norm.logpdf(action, mean, std))
        return (jnp.concatenate(actions, axis=-2),
                jnp.concatenate(log_probs, axis=-2))

    def best(self):
        return jnp.concatenate(
            [mean for mean, _ in self._head_params()], axis=-2)

    def action_stats(self, all_actions):
        log_probs, entropies = [], []
        for i, (mean, std) in enumerate(self._head_params()):
            action = all_actions[..., i, :][..., None, :]
            log_probs.append(jax.scipy.stats.norm.logpdf(action, mean, std))
            # Closed-form normal entropy.
            entropies.append(0.5 * jnp.log(2 * jnp.pi * jnp.square(std)) + 0.5)
        return (jnp.concatenate(log_probs, axis=-2),
                jnp.concatenate(entropies, axis=-2))


class DictActionDistributions(PyTreeNode):
    """Dict of named action distributions — the canonical actor output.

    The sim contract carries actions as ``{name: array}`` pytrees keyed like
    ``TrainConfig.actions``; this wrapper samples/scores every named
    distribution and returns matching dict pytrees, so PPO's per-key
    surrogate/entropy tree.maps and per-key entropy weights apply naturally.
    """

    dists: FrozenDict

    def sample(self, prng_key):
        names = sorted(self.dists.keys())
        keys = random.split(prng_key, len(names))
        actions, log_probs = {}, {}
        for key, name in zip(keys, names):
            actions[name], log_probs[name] = self.dists[name].sample(key)
        return FrozenDict(actions), FrozenDict(log_probs)

    def best(self):
        return FrozenDict({k: d.best() for k, d in self.dists.items()})

    def action_stats(self, all_actions):
        log_probs, entropies = {}, {}
        for name, dist in self.dists.items():
            log_probs[name], entropies[name] = dist.action_stats(
                all_actions[name])
        return FrozenDict(log_probs), FrozenDict(entropies)


def _symmetric_weighted_sum(probs, bins):
    """Sum p_i * b_i pairing bins symmetric about the midpoint.

    Plain left-to-right summation does not cancel exactly in float32; pairing
    the negative and positive halves keeps the mean at exactly 0 for a uniform
    distribution at init (DreamerV3 trick; reference: dists.py:143-168).
    """
    num_bins = bins.shape[-1]
    midpoint = (num_bins - 1) // 2
    p_lo, p_mid, p_hi = (probs[..., :midpoint],
                         probs[..., midpoint:midpoint + 1],
                         probs[..., midpoint + 1:])
    b_lo, b_mid, b_hi = (bins[..., :midpoint],
                         bins[..., midpoint:midpoint + 1],
                         bins[..., midpoint + 1:])
    return (
        (p_mid * b_mid).sum(axis=-1, keepdims=True)
        + ((p_lo * b_lo)[..., ::-1] + p_hi * b_hi).sum(axis=-1, keepdims=True)
    )


class SymExpTwoHotDistribution(PyTreeNode):
    """DreamerV3 two-hot categorical over symexp-spaced bins.

    Bin layout matches the reference's reduced range (symexp of linspace(-14,
    0) mirrored; reference: dists.py:128-141).
    """

    logits: jax.Array

    @staticmethod
    def create(logits):
        return SymExpTwoHotDistribution(logits=logits.astype(jnp.float32))

    def _compute_bins(self):
        num_bins = self.logits.shape[-1]
        assert num_bins % 2 == 1 and num_bins > 1
        half = symexp(jnp.linspace(-14, 0, num_bins // 2 + 1, dtype=jnp.float32))
        return jnp.concatenate([half, -half[:-1][::-1]], axis=0)

    def mean(self):
        bins = self._compute_bins()
        probs = jax.nn.softmax(self.logits)
        return _symmetric_weighted_sum(probs, bins)

    def two_hot_cross_entropy_loss(self, targets):
        assert targets.dtype == jnp.float32
        bins = self._compute_bins()
        num_bins = bins.shape[-1]

        lower_idx = (bins <= targets).astype(jnp.int32).sum(axis=-1) - 1
        upper_idx = num_bins - (bins > targets).astype(jnp.int32).sum(axis=-1)
        lower_idx = jnp.clip(lower_idx, 0, num_bins - 1)
        upper_idx = jnp.clip(upper_idx, 0, num_bins - 1)

        same_bin = lower_idx == upper_idx
        dist_lower = jnp.where(
            same_bin[..., None], 1.0, jnp.abs(bins[lower_idx, None] - targets))
        dist_upper = jnp.where(
            same_bin[..., None], 1.0, jnp.abs(bins[upper_idx, None] - targets))
        total = dist_lower + dist_upper

        # DreamerV3 weighting: the closer bin gets the larger weight, i.e.
        # weight_lower = dist_upper / total. (The reference's vendored copy
        # swaps these — dists.py:196-200 — putting more mass on the farther
        # bin; we use the correct interpolation so the distribution's mean
        # reproduces the target.)
        target_two_hot = (
            jax.nn.one_hot(lower_idx, num_bins) * (dist_upper / total)
            + jax.nn.one_hot(upper_idx, num_bins) * (dist_lower / total)
        )
        log_probs = _log_softmax(self.logits)
        return -(target_two_hot * log_probs).sum(-1, keepdims=True)


class HLGaussDist(PyTreeNode):
    """Histogram-Gaussian return distribution (M3 / "Stop Regressing").

    Soft labels come from integrating a Gaussian (sigma = smoothness * local
    bin width) over bin bounds via erf CDFs (reference: models.py:177-250).
    """

    logits: jax.Array
    smoothness: float = field(pytree_node=False)
    centers: jax.Array = field(pytree_node=False)
    bounds: jax.Array = field(pytree_node=False)

    def mean(self):
        probs = jax.nn.softmax(self.logits)
        return _symmetric_weighted_sum(probs, self.centers)

    def loss(self, targets):
        targets = jnp.clip(targets, self.centers[0], self.centers[-1])
        bounds = self.bounds

        lower_idx = (bounds <= targets).astype(jnp.int32).sum(axis=-1) - 1
        upper_idx = jnp.clip(lower_idx + 1, 1, bounds.size - 1)
        lower_idx = jnp.clip(lower_idx, 0, bounds.size - 2)
        width = bounds[upper_idx] - bounds[lower_idx]
        sigmas = self.smoothness * width[..., None]

        cdfs = jax.scipy.special.erf(
            (bounds - targets) / (jnp.sqrt(2.0) * sigmas))
        z = (cdfs[..., -1] - cdfs[..., 0])[..., None]
        soft_labels = (cdfs[..., 1:] - cdfs[..., :-1]) / z

        log_probs = _log_softmax(self.logits)
        return -(soft_labels * log_probs).sum(-1, keepdims=True)


class HLGaussTwoPartDist(PyTreeNode):
    """Sum of a fine-grained small-range and coarse large-range HL-Gauss dist.

    The target is split into a fractional part in (-2, 2) and the remainder,
    mirroring the reference's two-part critic (reference: models.py:309-322).
    """

    small_dist: HLGaussDist
    large_dist: HLGaussDist

    def mean(self):
        return self.small_dist.mean() + self.large_dist.mean()

    def loss(self, targets):
        small_tgt = targets % (jnp.where(targets >= 0, 1, -1) * 2)
        large_tgt = targets - small_tgt
        return self.small_dist.loss(small_tgt) + self.large_dist.loss(large_tgt)
