"""Per-policy state containers + the stacked population manager.

Capability parity with the reference state layer (reference:
train_state.py:24-487):

- ``PolicyState``: network params/batch-stats, obs-preprocess state, reward
  hyperparams, and fitness (EMA episode score or Elo MMR).
- ``PolicyTrainState``: optimizer state, value normalizer, max-advantage EMA,
  initial per-kernel weight norms (for the weight-projection regularizer),
  per-policy on-device hyperparameters, fp16 loss scaler, per-policy PRNG.
- ``TrainStateManager``: everything stacked along a leading policy axis, plus
  orbax checkpoint save/load (PRNG-key unwrap/rewrap), population re-slicing,
  and eval-time policy loading.

Deviation from the reference: optimizers are built *learning-rate-free* (adam moments
+ global-norm clip only) and the learning rate is applied from the on-device
``hyper_params.lr`` at update time. In the reference the lr is baked into the
optax chain at init (reference: ppo.py:84-90), so PBT lr mutation never
actually changes the step size; here mutation takes effect immediately and
per-policy lrs vmap/shard cleanly over the population axis.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import random

from .algo import AlgoBase, HyperParams
from .config import TrainConfig
from .observations import ObservationsPreprocess, ObservationsPreprocessNoop
from .ops.ema import EMAEstimate, EMANormalizer
from .ops.loss_scale import DynamicScale
from .policy import Policy
from .struct import FrozenDict, PyTreeNode, field, freeze


def map_adam_moments(opt_state, fn):
    """Apply ``fn`` to the mu/nu subtrees of every ScaleByAdamState.

    Structure-preserving walk over an optax chain state (nested tuples /
    optax namedtuple states). Used by the ZeRO optimizer-state sharding
    (``MeshConfig.zero_opt_state``) to re-layout or spec-annotate the Adam
    moments without disturbing the rest of the state. Also works on spec
    pytrees produced by ``jax.tree.map`` over a real state (tree.map
    preserves the namedtuple containers). The reference has no analog —
    its optimizers are single-device (reference: train.py:144-146).
    """
    def rec(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(mu=fn(s.mu), nu=fn(s.nu))
        if isinstance(s, tuple):
            if hasattr(s, "_fields"):  # other namedtuple optax states
                return type(s)(*(rec(x) for x in s))
            return tuple(rec(x) for x in s)
        return s

    return rec(opt_state)


def chunk_adam_moments(opt_state, zero_rows: int):
    """Re-layout Adam mu/nu leaves to the ZeRO-sharded chunk layout.

    Each param-shaped moment leaf becomes ``[zero_rows, ceil(size /
    zero_rows)]`` (flattened, zero-padded): axis 0 is sharded over the
    learn region's replica axes (``data`` x ``model``) so each device
    stores 1/R of the moments (see ppo._zero_sharded_opt_update and
    docs/scaling.md). Raises if the state contains no Adam moments to
    shard (an optimizer this framework did not build).
    """
    found = []

    def chunk_leaf(x):
        flat = x.reshape(-1)
        pad = (-flat.size) % zero_rows
        if pad:
            flat = jnp.pad(flat, (0, pad))
        return flat.reshape(zero_rows, -1)

    def chunk_tree(tree):
        found.append(True)
        return jax.tree.map(chunk_leaf, tree)

    out = map_adam_moments(opt_state, chunk_tree)
    if not found:
        raise ValueError(
            "zero_opt_state=True but the optimizer state holds no "
            "ScaleByAdamState to shard; it only supports the "
            "clip+scale_by_adam chain PPO.make_optimizer builds")
    return out


class MovingEpisodeScore(PyTreeNode):
    mean: jax.Array
    var: jax.Array
    N: jax.Array


class MMR(PyTreeNode):
    elo: jax.Array


class PolicyState(PyTreeNode):
    apply_fn: Callable = field(pytree_node=False)
    rnn_reset_fn: Callable = field(pytree_node=False)

    params: FrozenDict
    batch_stats: FrozenDict

    obs_preprocess: ObservationsPreprocess = field(
        pytree_node=False)
    obs_preprocess_state: FrozenDict

    reward_hyper_params: Optional[jax.Array]

    get_episode_scores_fn: Callable = field(pytree_node=False)
    episode_score: Optional[MovingEpisodeScore]
    mmr: Optional[MMR]

    def update(self, **changes):
        return self.replace(**changes)


class PolicyTrainState(PyTreeNode):
    value_normalizer: Optional[EMANormalizer] = field(
        pytree_node=False)
    max_advantage_est: EMAEstimate = field(pytree_node=False)
    tx: optax.GradientTransformation = field(pytree_node=False)

    initial_weight_norms: FrozenDict
    value_normalizer_state: Optional[FrozenDict]
    max_advantage_est_state: FrozenDict
    hyper_params: HyperParams
    opt_state: optax.OptState
    scaler: Optional[DynamicScale]
    update_prng_key: jax.Array

    def update(self, **changes):
        return self.replace(**changes)

    def gen_update_rnd(self):
        rnd, next_key = random.split(self.update_prng_key)
        return rnd, self.update(update_prng_key=next_key)


def _ocp():
    """orbax, imported only when a checkpoint is written or read: it is
    not needed to train."""
    import orbax.checkpoint

    return orbax.checkpoint


_ASYNC_CHECKPOINTER = None


def _async_checkpointer():
    """Process-wide AsyncCheckpointer (owns a background thread + barrier
    state, so it must be shared across saves)."""
    global _ASYNC_CHECKPOINTER
    if _ASYNC_CHECKPOINTER is None:
        _ASYNC_CHECKPOINTER = _ocp().AsyncCheckpointer(
            _ocp().PyTreeCheckpointHandler())
    return _ASYNC_CHECKPOINTER


def wait_for_checkpoints():
    """Block until every async checkpoint save has committed to disk."""
    if _ASYNC_CHECKPOINTER is not None:
        _ASYNC_CHECKPOINTER.wait_until_finished()


class TrainStateManager(PyTreeNode):
    """Stacked per-policy states + population-level PRNG and user state."""

    policy_states: PolicyState
    train_states: PolicyTrainState
    pbt_rng: jax.Array
    user_state: Any

    # -- checkpointing -------------------------------------------------------

    def _ckpt_tree(self, next_update):
        """The checkpoint pytree: PRNG keys unwrapped to their uint32 key
        data (sharding-preserving — no host transfer), everything else left
        as (possibly multi-host-sharded) ``jax.Array``s for orbax to
        serialize collectively."""

        def prepare(x):
            if isinstance(x, jax.Array) and jnp.issubdtype(
                    x.dtype, jax.dtypes.prng_key):
                return random.key_data(x)
            return x

        return {
            "next_update": np.asarray(jax.device_get(next_update)),
            "policy_states": jax.tree.map(prepare, self.policy_states),
            "train_states": jax.tree.map(prepare, self.train_states),
            "pbt_rng": prepare(self.pbt_rng),
            "user_state": jax.tree.map(prepare, self.user_state),
        }

    def save(self, next_update, path, block=True):
        """Collective checkpoint save.

        Multi-host safe (unlike the reference's host-gather flow, reference:
        train_state.py:145-165): sharded leaves go to orbax as global
        ``jax.Array``s, so every process writes only its addressable shards
        and no cross-host gather or full-tree host copy happens. Call from
        ALL processes.

        ``block=False`` uses orbax's AsyncCheckpointer: device buffers are
        snapshotted synchronously but serialization/IO overlaps continued
        training; call :func:`wait_for_checkpoints` (or issue another save)
        before relying on the files.
        """
        path = os.path.abspath(path)  # orbax requires absolute paths
        if block:
            checkpointer = _ocp().PyTreeCheckpointer()
            checkpointer.save(path, self._ckpt_tree(next_update))
        else:
            # Snapshot on-device first: the caller typically donates the
            # live state into the next update while serialization is still
            # reading, and orbax holds references rather than copying.
            snapshot = jax.tree.map(
                lambda x: jnp.copy(x) if isinstance(x, jax.Array) else x,
                self._ckpt_tree(next_update))
            _async_checkpointer().save(path, snapshot)

    def load(self, path):
        """Collective restore; each leaf comes back with the sharding the
        corresponding leaf of ``self`` currently has. Call from ALL
        processes."""
        path = os.path.abspath(path)
        checkpointer = _ocp().PyTreeCheckpointer()
        restore_desc = self._ckpt_tree(jnp.zeros((), jnp.int32))
        restore_args = _ocp().checkpoint_utils.\
            construct_restore_args(restore_desc)
        loaded = checkpointer.restore(
            path, item=restore_desc, restore_args=restore_args)

        def restore_leaf(a, b):
            if jnp.issubdtype(b.dtype, jax.dtypes.prng_key):
                return random.wrap_key_data(jnp.asarray(a))
            if isinstance(a, (np.ndarray, jax.Array)):
                return jnp.asarray(a, dtype=b.dtype)
            return a

        return self.replace(
            policy_states=jax.tree.map(
                restore_leaf, loaded["policy_states"], self.policy_states),
            train_states=jax.tree.map(
                restore_leaf, loaded["train_states"], self.train_states),
            pbt_rng=jax.tree.map(
                restore_leaf, loaded["pbt_rng"], self.pbt_rng),
            user_state=jax.tree.map(
                restore_leaf, loaded["user_state"], self.user_state),
        ), loaded["next_update"]

    @staticmethod
    def restore_host(path):
        """Restore a checkpoint tree as host numpy arrays (no device
        placement) — for population surgery and cross-platform inspection
        where the saving topology may not exist."""
        path = os.path.abspath(path)
        checkpointer = _ocp().PyTreeCheckpointer()
        meta = checkpointer.metadata(path).item_metadata
        restore_args = jax.tree.map(
            lambda _: _ocp().RestoreArgs(restore_type=np.ndarray),
            meta.tree)
        return checkpointer.restore(path, restore_args=restore_args)

    @staticmethod
    def slice_checkpoint(src, dst, train_select, past_select):
        """Re-slice a checkpointed population into a new train/past split."""
        src, dst = os.path.abspath(src), os.path.abspath(dst)
        checkpointer = _ocp().PyTreeCheckpointer()
        loaded = TrainStateManager.restore_host(src)

        train_states = jax.tree.map(
            lambda x: x[train_select], loaded["train_states"])
        train_policy = jax.tree.map(
            lambda x: x[train_select], loaded["policy_states"])
        past_policy = jax.tree.map(
            lambda x: x[past_select], loaded["policy_states"])
        policy_states = jax.tree.map(
            lambda x, y: np.concatenate([x, y], axis=0),
            train_policy, past_policy)

        checkpointer.save(dst, {
            "next_update": loaded["next_update"],
            "policy_states": policy_states,
            "train_states": train_states,
            "pbt_rng": loaded["pbt_rng"],
            "user_state": loaded["user_state"],
        })

    @staticmethod
    def load_policies(policy: Policy, path):
        """Load just the policy states from a checkpoint (for eval)."""
        path = os.path.abspath(path)
        checkpointer = _ocp().PyTreeCheckpointer()
        loaded = checkpointer.restore(path)

        actor_critic = policy.actor_critic
        obs_preprocess = (
            policy.obs_preprocess or ObservationsPreprocessNoop.create())

        to_jax = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a

        num_train_policies = (
            loaded["train_states"]["update_prng_key"].shape[0])

        get_episode_scores_fn = (
            policy.get_episode_scores or (lambda x: 0.0))

        episode_score = loaded["policy_states"]["episode_score"]
        mmr = loaded["policy_states"]["mmr"]
        total_num_policies = num_train_policies
        if episode_score is not None:
            episode_score = MovingEpisodeScore(
                **jax.tree.map(to_jax, episode_score))
            total_num_policies = episode_score.mean.shape[0]
        if mmr is not None:
            mmr = MMR(**jax.tree.map(to_jax, mmr))
            total_num_policies = mmr.elo.shape[0]

        return PolicyState(
            apply_fn=actor_critic.apply,
            rnn_reset_fn=actor_critic.clear_recurrent_state,
            params=jax.tree.map(to_jax, loaded["policy_states"]["params"]),
            batch_stats=jax.tree.map(
                to_jax, loaded["policy_states"]["batch_stats"]),
            obs_preprocess=obs_preprocess,
            obs_preprocess_state=freeze(jax.tree.map(
                to_jax, loaded["policy_states"]["obs_preprocess_state"])),
            reward_hyper_params=jax.tree.map(
                to_jax, loaded["policy_states"]["reward_hyper_params"]),
            get_episode_scores_fn=get_episode_scores_fn,
            episode_score=episode_score,
            mmr=mmr,
        ), num_train_policies, total_num_policies

    # -- construction --------------------------------------------------------

    @staticmethod
    def create(
        policy: Policy,
        cfg: TrainConfig,
        algo: AlgoBase,
        init_user_state_cb: Callable,
        base_rng,
        example_obs,
        use_competitive_mmr: bool,
    ) -> "TrainStateManager":
        base_init_rng, pbt_rng = random.split(base_rng)

        make = jax.jit(partial(
            _make_policies, policy, cfg, algo, use_competitive_mmr))
        policy_states, train_states = make(base_init_rng, example_obs)

        return TrainStateManager(
            policy_states=policy_states,
            train_states=train_states,
            pbt_rng=pbt_rng,
            user_state=init_user_state_cb(),
        )


def _setup_value_normalizer(hyper_params, fake_values):
    normalizer = EMANormalizer(
        decay=hyper_params.value_normalizer_decay,
        norm_dtype=fake_values.dtype,
        inv_dtype=jnp.float32,
        disable=not hyper_params.normalize_values,
    )
    return normalizer, normalizer.init_estimates(fake_values)


def _setup_policy_state(policy, cfg, use_competitive_mmr, prng_key, obs):
    actor_critic = policy.actor_critic
    obs_preprocess = (
        policy.obs_preprocess or ObservationsPreprocessNoop.create())

    # Batch-1 recurrent state purely for parameter init; the rollout engine
    # owns the real (sim-batch-sized) recurrent state.
    rnn_states = actor_critic.init_recurrent_state(1)

    obs_preprocess_state = obs_preprocess.init_state(obs, False)
    preprocessed_obs = obs_preprocess.preprocess(
        obs_preprocess_state, obs, False)

    (fake_outs, rnn_states), variables = actor_critic.init_with_output(
        prng_key, random.PRNGKey(0), rnn_states, preprocessed_obs,
        method="rollout")

    num_reward_hyperparams = (
        len(cfg.pbt.reward_hyper_params_explore) if cfg.pbt else 0)
    reward_hyper_params = (
        jnp.zeros((num_reward_hyperparams,), jnp.float32)
        if num_reward_hyperparams > 0 else None)

    get_episode_scores_fn = policy.get_episode_scores or (lambda x: 0.0)

    if use_competitive_mmr:
        mmr = MMR(elo=jnp.array(1500, jnp.float32))
        episode_score = None
    else:
        mmr = None
        episode_score = MovingEpisodeScore(
            mean=jnp.array(0, jnp.float32),
            var=jnp.array(0, jnp.float32),
            N=jnp.array(0, jnp.int32),
        )

    return PolicyState(
        apply_fn=actor_critic.apply,
        rnn_reset_fn=actor_critic.clear_recurrent_state,
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        obs_preprocess=obs_preprocess,
        obs_preprocess_state=obs_preprocess_state,
        reward_hyper_params=reward_hyper_params,
        get_episode_scores_fn=get_episode_scores_fn,
        episode_score=episode_score,
        mmr=mmr,
    ), fake_outs, rnn_states


def _setup_train_state(cfg, algo, prng_key, policy_state, fake_policy_out):
    hyper_params = algo.init_hyperparams(cfg)
    optimizer = algo.make_optimizer(hyper_params)

    if cfg.normalize_values:
        assert fake_policy_out["critic"].shape[-1] == 1
        value_norm, value_norm_state = _setup_value_normalizer(
            hyper_params, fake_policy_out["critic"])
    else:
        value_norm, value_norm_state = None, None

    opt_state = optimizer.init(policy_state.params)
    zero_rows = cfg.mesh.zero_rows if cfg.mesh is not None else 1
    if zero_rows > 1:
        # ZeRO optimizer-state sharding: moments store in the chunked
        # [R, ceil(size/R)] layout (sharded over data x model by the
        # manual learn region's specs; train.py:learn_manual).
        opt_state = chunk_adam_moments(opt_state, zero_rows)

    scaler = DynamicScale() if cfg.compute_dtype == jnp.float16 else None

    max_advantage_est = EMAEstimate(decay=hyper_params.max_advantage_est_decay)
    max_advantage_est_state = max_advantage_est.init_estimates(jnp.zeros((1,)))

    # Initial L2 norm of every Dense kernel outside the actor/critic heads;
    # PPO projects weights back to these norms after each step.
    def initial_norm(path, x):
        if path[-1].key == "kernel":
            return jnp.linalg.vector_norm(x, ord=2)
        return None

    initial_weight_norms = jax.tree_util.tree_map_with_path(
        initial_norm, policy_state.params)
    initial_weight_norms = dict(initial_weight_norms)
    for head in ("actor", "critic"):
        if head in initial_weight_norms:
            initial_weight_norms[head] = jax.tree.map(
                lambda x: None, initial_weight_norms[head])

    return PolicyTrainState(
        value_normalizer=value_norm,
        max_advantage_est=max_advantage_est,
        tx=optimizer,
        initial_weight_norms=initial_weight_norms,
        value_normalizer_state=value_norm_state,
        max_advantage_est_state=max_advantage_est_state,
        hyper_params=hyper_params,
        opt_state=opt_state,
        scaler=scaler,
        update_prng_key=prng_key,
    )


def _make_policies(policy, cfg, algo, use_competitive_mmr, base_init_rnd,
                   example_obs):
    """vmapped init of the train population, tiled out for past policies."""
    if cfg.pbt is not None:
        num_make = cfg.pbt.num_train_policies
        num_past = cfg.pbt.num_past_policies
    else:
        num_make, num_past = 1, 0

    # Batch-1 example obs, broadcast to every policy (only shapes matter).
    obs = jax.tree.map(lambda x: x[0:1, ...], example_obs)

    policy_rnd, train_rnd = random.split(base_init_rnd)

    setup_policies = jax.vmap(
        partial(_setup_policy_state, policy, cfg, use_competitive_mmr),
        in_axes=(0, None))
    policy_states, fake_outs, _ = setup_policies(
        random.split(policy_rnd, num_make), obs)

    setup_train = jax.vmap(partial(_setup_train_state, cfg, algo))
    train_states = setup_train(
        random.split(train_rnd, num_make), policy_states, fake_outs)

    if num_past > 0:
        num_repeats = -(num_past // -num_make)

        def tile(x):
            reps = (num_repeats + 1,) + (1,) * (x.ndim - 1)
            return jnp.tile(x, reps)[0:num_make + num_past]

        policy_states = jax.tree.map(tile, policy_states)

    return policy_states, train_states
