"""Observation preprocessing pipelines keyed on obs-dict entries.

Capability parity with the reference observation system (reference:
observations.py:13-160), redesigned around per-key *handlers* instead of an
inheritance protocol: a preprocessor is a bundle of five per-key operations

    preprocess(state, ob)            -> network-ready ob
    init_state(ob)                   -> persistent normalizer state
    update_state(state, stats)       -> fold streamed stats into the state
    init_obs_stats(state)            -> fresh streaming-stats accumulator
    update_obs_stats(state, stats, n, ob) -> accumulate one batch

mapped over the obs dict, with optional vmap over a leading policy axis.
The stats split keeps the rollout loop cheap: per-step calls only
accumulate batch stats; the EMA fold (``update_state``) runs once per
update, so inference normalization stays frozen within a rollout phase.

Sharding note: every operation is elementwise over the (possibly
data-sharded) batch except the stats reductions, which XLA turns into psums
across shards — exactness is guaranteed by the Chan-style merge in
ops/ema.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Set

import jax
import jax.numpy as jnp

from .ops.ema import EMANormalizer
from .struct import FrozenDict

# A handler op takes (state_or_none, *per_key_args) for one obs key.
_NOOP = lambda *args: None


@dataclass(frozen=True)
class KeyOps:
    """The five per-key operations. Defaults are stateless no-ops."""

    preprocess: Callable = lambda state, ob: ob
    init_state: Callable = lambda ob: None
    update_state: Callable = _NOOP
    init_obs_stats: Callable = _NOOP
    # axis_name: mesh axis to reduce batch moments over, when the stats
    # update runs inside a manual shard_map region on a batch slice.
    update_obs_stats: Callable = (
        lambda state, stats, n, ob, axis_name=None: None)


class ObservationsPreprocess:
    """Maps per-key ops over obs dicts, vmapping over stacked policies.

    Subclasses implement ``_ops(key) -> KeyOps``; results are cached per key.
    """

    def _ops(self, ob_name: str) -> KeyOps:
        return KeyOps()

    def _get_ops(self, ob_name):
        cache = getattr(self, "_ops_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_ops_cache", cache)
        if ob_name not in cache:
            cache[ob_name] = self._ops(ob_name)
        return cache[ob_name]

    def _apply(self, op_name, vmap, *tree_args):
        keys = tree_args[0].keys()
        out = {}
        for ob_name in keys:
            op = getattr(self._get_ops(ob_name), op_name)
            args = tuple(t[ob_name] for t in tree_args)
            if vmap:
                axes = tuple(0 if a is not None else None for a in args)
                fn = jax.vmap(op, in_axes=axes) if any(
                    ax == 0 for ax in axes) else op
            else:
                fn = op
            out[ob_name] = fn(*args)
        return FrozenDict(out)

    # -- public surface (consumed by rollouts/train) -------------------------

    def preprocess(self, states, obs, vmap):
        return self._apply("preprocess", vmap, states, obs)

    def init_state(self, obs, vmap):
        return self._apply("init_state", vmap, obs)

    def update_state(self, states, o_stats, vmap):
        return self._apply("update_state", vmap, states, o_stats)

    def init_obs_stats(self, states, vmap):
        return self._apply("init_obs_stats", vmap, states)

    def update_obs_stats(self, states, cur_obs_stats, num_prev_updates, obs,
                         vmap, axis_name=None):
        keys = states.keys()
        out = {}
        for ob_name in keys:
            op = self._get_ops(ob_name).update_obs_stats
            # Back-compat: custom KeyOps written to the pre-round-5 4-arg
            # contract keep working on single-device / GSPMD paths; inside
            # the manual collect region (axis_name set) shard-local stats
            # would silently skew the normalizer, so that combination is
            # a hard error, not a fallback.
            takes_axis = True
            try:
                import inspect
                params = inspect.signature(op).parameters
                takes_axis = ("axis_name" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()))
            except (TypeError, ValueError):
                pass  # builtins/partials without signatures: assume new
            if not takes_axis and axis_name is not None:
                raise TypeError(
                    f"custom update_obs_stats for obs key '{ob_name}' does "
                    f"not accept axis_name, but the manual collect region "
                    f"needs cross-shard batch moments (pmean over "
                    f"'{axis_name}'). Add axis_name=None to its signature "
                    f"(reduce with jax.lax.pmean/psum when set) or disable "
                    f"the region with MeshConfig(manual_collect=False).")

            def call(s, c, o, op=op, takes_axis=takes_axis):
                if takes_axis:
                    return op(s, c, num_prev_updates, o, axis_name=axis_name)
                return op(s, c, num_prev_updates, o)

            args = (states[ob_name], cur_obs_stats[ob_name], obs[ob_name])
            if vmap:
                axes = tuple(0 if a is not None else None for a in args)
                fn = jax.vmap(call, in_axes=axes) if any(
                    ax == 0 for ax in axes) else call
            else:
                fn = call
            out[ob_name] = fn(*args)
        return FrozenDict(out)


@dataclass(frozen=True)
class ObservationsEMANormalizer(ObservationsPreprocess):
    """Per-key EMA mean/sigma normalization with optional prep functions and
    a skip set for keys that should pass through raw."""

    normalizer: EMANormalizer
    prep_fns: Dict[str, Callable] = field(default_factory=dict)
    skip_normalization: Set[str] = field(default_factory=frozenset)

    @staticmethod
    def create(
        decay: float,
        dtype: jnp.dtype,
        eps: float = 1e-5,
        prep_fns: Dict[str, Callable] = {},
        skip_normalization: Set[str] = frozenset(),
    ):
        return ObservationsEMANormalizer(
            normalizer=EMANormalizer(
                decay=decay, norm_dtype=dtype, inv_dtype=dtype, eps=eps),
            prep_fns=dict(prep_fns),
            skip_normalization=frozenset(skip_normalization),
        )

    def _ops(self, ob_name):
        prep = self.prep_fns.get(ob_name, lambda x: x)

        if ob_name in self.skip_normalization:
            return KeyOps(preprocess=lambda state, ob: prep(ob))

        norm = self.normalizer
        return KeyOps(
            preprocess=lambda est, ob: norm.normalize(est, prep(ob)),
            init_state=lambda ob: norm.init_estimates(prep(ob)),
            update_state=norm.update_estimates,
            init_obs_stats=norm.init_input_stats,
            update_obs_stats=lambda est, stats, n, ob, axis_name=None: (
                norm.update_input_stats(stats, n, prep(ob),
                                        axis_name=axis_name)),
        )


@dataclass(frozen=True)
class ObservationsCaster(ObservationsPreprocess):
    """Cast every obs entry to one dtype (e.g. raw int obs -> bf16)."""

    dtype: jnp.dtype

    @staticmethod
    def create(dtype: jnp.dtype):
        return ObservationsCaster(dtype=dtype)

    def _ops(self, ob_name):
        return KeyOps(preprocess=lambda state, ob: ob.astype(self.dtype))


@dataclass(frozen=True)
class ObservationsPreprocessNoop(ObservationsPreprocess):
    @staticmethod
    def create():
        return ObservationsPreprocessNoop()
