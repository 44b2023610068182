"""Actor and critic heads.

Capability parity with the reference heads (reference: models.py:122-378):
discrete-action dense actor, scalar critic, DreamerV3 two-hot critic, HL-Gauss
critic (linear bins) and two-part HL-Gauss critic (float-format-spaced bins).
Bin tables are built host-side in numpy (static) and baked into the modules.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from ..config import DiscreteActionsConfig
from ..ops.dists import (
    DictActionDistributions,
    DiscreteActionDistributions,
    HLGaussDist,
    HLGaussTwoPartDist,
    SymExpTwoHotDistribution,
)
from ..struct import FrozenDict


class DenseLayerDiscreteActor(nn.Module):
    cfg: DiscreteActionsConfig
    dtype: jnp.dtype
    weight_init: Callable = jax.nn.initializers.orthogonal(scale=0.01)

    def setup(self):
        total_action_dim = sum(self.cfg.actions_num_buckets)
        self.impl = nn.Dense(
            total_action_dim,
            use_bias=True,
            kernel_init=self.weight_init,
            bias_init=jax.nn.initializers.constant(0),
            dtype=self.dtype,
        )

    def __call__(self, features, train=False):
        logits = self.impl(features)
        return DiscreteActionDistributions(
            self.cfg.actions_num_buckets, logits)


class DictActor(nn.Module):
    """Actor composing named heads into a ``DictActionDistributions``.

    Use one entry per ``TrainConfig.actions`` key; the sampled actions come
    back as a matching ``{name: array}`` pytree, which is the layout the sim
    step contract consumes.
    """

    heads: Dict[str, nn.Module]

    @nn.compact
    def __call__(self, features, train=False):
        return DictActionDistributions(
            dists=FrozenDict({
                name: head(features, train=train)
                for name, head in self.heads.items()
            }))


class DenseLayerCritic(nn.Module):
    dtype: jnp.dtype
    weight_init: Callable = jax.nn.initializers.orthogonal(scale=1.0)

    @nn.compact
    def __call__(self, features, train=False):
        return nn.Dense(
            1,
            use_bias=True,
            kernel_init=self.weight_init,
            bias_init=jax.nn.initializers.constant(0),
            dtype=self.dtype,
        )(features).astype(jnp.float32)


class DreamerV3Critic(nn.Module):
    """Two-hot symexp critic; zero-init head so the mean starts at exactly 0."""

    dtype: jnp.dtype
    weight_init: Callable = jax.nn.initializers.constant(0)
    num_bins: int = 63

    @nn.compact
    def __call__(self, features, train=False):
        logits = nn.Dense(
            self.num_bins,
            use_bias=True,
            kernel_init=self.weight_init,
            bias_init=jax.nn.initializers.constant(0),
            dtype=self.dtype,
        )(features)
        return SymExpTwoHotDistribution.create(logits)


def make_hlgauss_bins(num_bins: int = 127, min_bound: float = -100,
                      max_bound: float = 100):
    """Symmetric linear bins: centers [num_bins], bounds [num_bins + 1]."""
    half = np.linspace(min_bound, 0, num_bins // 2 + 1)
    centers = np.concatenate([half, -half[:-1][::-1]], axis=0)
    width = centers[1] - centers[0]
    bounds = centers - 0.5 * width
    bounds = np.concatenate([bounds, [bounds[-1] + width]], axis=0)
    return (jnp.asarray(centers, jnp.float32), jnp.asarray(bounds, jnp.float32))


def _make_float_format_bins(num_mantissa_bits: int, num_exp_bits: int,
                            bias: int, denorm: bool):
    """Bins spaced like a tiny float format: dense near 0, sparse far out."""
    half, widths = [], []
    for exp in range(2**num_exp_bits):
        if denorm and exp == 0:
            scale = 2.0 ** (1 - bias)
        else:
            scale = 2.0 ** (exp - bias)
        width = scale / (2**num_mantissa_bits)
        for mantissa in range(2**num_mantissa_bits):
            frac = mantissa / (2**num_mantissa_bits)
            if denorm and exp == 0:
                half.append(frac * scale)
            elif exp == 0 and mantissa == 0:
                half.append(0.0)
            else:
                half.append((1 + frac) * scale)
            widths.append(width)

    half = np.asarray(half, np.float32)
    centers = np.concatenate([-half[:0:-1], half])
    widths = np.asarray(widths, np.float32)
    widths = np.concatenate([widths[:0:-1], widths])
    bounds = centers - 0.5 * widths
    bounds = np.concatenate([bounds, [bounds[-1] + widths[-1]]])
    return (jnp.asarray(centers, jnp.float32), jnp.asarray(bounds, jnp.float32))


def make_hlgauss_two_part_bins():
    """(small, large) bin tables for the two-part critic.

    Small covers the fractional range with a fp(3, 3) layout biased toward
    tiny magnitudes; large covers the integer range (reference:
    models.py:380-420).
    """
    small = _make_float_format_bins(3, 3, bias=2**3 - 1, denorm=True)
    large = _make_float_format_bins(3, 3, bias=-3, denorm=True)
    return small, large


class HLGaussCritic(nn.Module):
    dtype: jnp.dtype
    centers: jax.Array
    bounds: jax.Array
    smoothness: float = 0.75
    weight_init: Callable = jax.nn.initializers.constant(0)

    @staticmethod
    def create(dtype, num_bins: int = 127, min_bound=-100, max_bound=100,
               smoothness: float = 0.75):
        centers, bounds = make_hlgauss_bins(num_bins, min_bound, max_bound)
        return HLGaussCritic(
            dtype=dtype, centers=centers, bounds=bounds, smoothness=smoothness)

    @nn.compact
    def __call__(self, features, train=False):
        logits = nn.Dense(
            self.centers.shape[0],
            use_bias=True,
            kernel_init=self.weight_init,
            bias_init=jax.nn.initializers.constant(0),
            dtype=self.dtype,
        )(features)
        return HLGaussDist(
            logits=logits.astype(jnp.float32),
            smoothness=self.smoothness,
            centers=self.centers,
            bounds=self.bounds,
        )


class HLGaussTwoPartCritic(nn.Module):
    dtype: jnp.dtype
    small_centers: jax.Array
    small_bounds: jax.Array
    large_centers: jax.Array
    large_bounds: jax.Array
    smoothness: float = 0.75
    weight_init: Callable = jax.nn.initializers.constant(0)

    @staticmethod
    def create(dtype, smoothness: float = 0.75):
        (sc, sb), (lc, lb) = make_hlgauss_two_part_bins()
        return HLGaussTwoPartCritic(
            dtype=dtype, small_centers=sc, small_bounds=sb,
            large_centers=lc, large_bounds=lb, smoothness=smoothness)

    @nn.compact
    def __call__(self, features, train=False):
        def head(n, name):
            return nn.Dense(
                n,
                use_bias=True,
                kernel_init=self.weight_init,
                bias_init=jax.nn.initializers.constant(0),
                dtype=self.dtype,
                name=name,
            )(features).astype(jnp.float32)

        return HLGaussTwoPartDist(
            small_dist=HLGaussDist(
                logits=head(self.small_centers.shape[0], "small"),
                smoothness=self.smoothness,
                centers=self.small_centers,
                bounds=self.small_bounds,
            ),
            large_dist=HLGaussDist(
                logits=head(self.large_centers.shape[0], "large"),
                smoothness=self.smoothness,
                centers=self.large_centers,
                bounds=self.large_bounds,
            ),
        )
