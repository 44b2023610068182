"""Regression tests for PPO per-trajectory minibatch weighting.

The importance-sampling and advantage-filter paths must weight each
*trajectory* in the minibatch individually: weights enter ``_ppo_update`` as
``[minibatch, 1]`` and broadcast against the time-major ``[T, mb, ...]``
per-element losses. A 1-D ``[mb]`` weight vector instead broadcasts to
``[T, mb, mb]``, silently degenerating every weighted mean to
``mean(w) * mean(loss)`` (destroying the unbiasedness correction of
importance sampling; reference semantics: ppo.py:407-435) and inflating
memory by ``mb``x. This test drives ``_ppo`` with a handcrafted linear
"policy" whose loss is computable in closed form and asserts the recorded
loss equals the hand-computed per-trajectory weighted loss exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
from madrona_learn_tpu.struct import FrozenDict
from jax import random

import madrona_learn_tpu as mlt
from madrona_learn_tpu.observations import ObservationsPreprocessNoop
from madrona_learn_tpu.ops.ema import EMAEstimate
from madrona_learn_tpu.ops.metrics import TrainingMetrics
from madrona_learn_tpu.ppo import PPO, _ppo
from madrona_learn_tpu.rollouts import RolloutData
from madrona_learn_tpu.train_state import PolicyState, PolicyTrainState

N = 16  # trajectories per policy
T = 4   # steps per trajectory
MB = 4  # minibatch size


def _fake_apply(variables, rnn_start_states, dones, actions, obs,
                train=False, method=None, mutable=None):
    """A 'network' whose outputs are exactly predictable from the obs:
    log-probs equal the stored ones (ratio == 1 so the clipped surrogate
    reduces to the raw advantages) and the critic is obs['vbase'] scaled by
    the single parameter (init 1.0), so gradients flow but values are known.
    """
    w = variables["params"]["dense"]["kernel"][0]
    fwd = {
        "log_probs": FrozenDict({"a": obs["old_lp"] + 0.0 * w}),
        "entropies": FrozenDict({"a": obs["ent"] + 0.0 * w}),
        "critic": obs["vbase"] * w,
    }
    return fwd, {"batch_stats": {}}


def _make_cfg(**overrides):
    base = dict(
        num_worlds=N,
        num_agents_per_world=1,
        num_updates=1,
        actions={"a": mlt.DiscreteActionsConfig(actions_num_buckets=[3])},
        steps_per_update=T,
        num_bptt_chunks=1,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=MB,
            clip_coef=0.2,
            value_loss_coef=0.7,
            entropy_coef=0.013,
            max_grad_norm=10.0,
        ),
        dreamer_v3_critic=False,
        normalize_advantages=False,
        normalize_values=False,
        importance_sample_trajectories=True,
        importance_sample_num_minibatches=1,
    )
    base.update(overrides)
    return mlt.TrainConfig(**base)


def _make_states_and_data(cfg, key_seed=7, data_seed=3):
    algo = PPO()
    hp = algo.init_hyperparams(cfg)
    tx = algo.make_optimizer(hp)

    params = {"dense": {"kernel": jnp.ones((1,), jnp.float32)}}

    policy_state = PolicyState(
        apply_fn=_fake_apply,
        rnn_reset_fn=lambda states, dones: states,
        params=params,
        batch_stats={},
        obs_preprocess=ObservationsPreprocessNoop.create(),
        obs_preprocess_state=FrozenDict({}),
        reward_hyper_params=None,
        get_episode_scores_fn=lambda x: 0.0,
        episode_score=None,
        mmr=None,
    )

    max_adv_est = EMAEstimate(decay=cfg.max_advantage_est_decay)
    train_state = PolicyTrainState(
        value_normalizer=None,
        max_advantage_est=max_adv_est,
        tx=tx,
        initial_weight_norms={"dense": {"kernel": None}},
        value_normalizer_state=None,
        max_advantage_est_state=max_adv_est.init_estimates(jnp.zeros((1,))),
        hyper_params=hp,
        opt_state=tx.init(params),
        scaler=None,
        update_prng_key=random.key(key_seed),
    )

    rng = np.random.default_rng(data_seed)
    f32 = lambda *shape: jnp.asarray(
        rng.standard_normal(shape), jnp.float32)
    data = FrozenDict({
        "advantages": f32(N, T, 1),
        "returns": f32(N, T, 1),
        "values": f32(N, T, 1),
        "dones": jnp.zeros((N, T, 1), jnp.bool_),
        "actions": {"a": jnp.zeros((N, T, 1), jnp.int32)},
        "log_probs": {"a": f32(N, T, 1)},
        "obs": {
            "old_lp": None,  # filled below: must equal log_probs exactly
            "ent": f32(N, T, 1),
            "vbase": f32(N, T, 1),
        },
        "rnn_start_states": jnp.zeros((N, 1), jnp.float32),
    })
    data = data.copy({"obs": dict(data["obs"], old_lp=data["log_probs"]["a"])})

    rollout_data = RolloutData(
        data=data,
        num_train_seqs_per_policy=N,
        num_train_policies=1,
    )
    return policy_state, train_state, rollout_data


def _stack1(tree):
    return jax.tree.map(lambda x: jnp.asarray(x)[None], tree)


def _run_ppo(cfg, policy_state, train_state, rollout_data):
    """Mirror train.py's vmapped per-policy update with one policy."""
    metrics = TrainingMetrics.create(
        PPO().add_metrics(cfg, FrozenDict({})),
        buffer_size=1, start_update_idx=0, num_policies=1)

    noop_cb = lambda m, epoch, mb, ps, ts: m

    @jax.jit
    @jax.vmap
    def update(ps, ts, rd, m):
        return _ppo(cfg, ps, ts, rd, noop_cb, m)

    return update(_stack1(policy_state), _stack1(train_state),
                  _stack1(rollout_data), metrics)


def _expected_importance_sampled_loss(cfg, train_state, rollout_data):
    """Closed-form replication of the importance-sampled minibatch loss."""
    data = rollout_data.data
    adv = data["advantages"].astype(jnp.float32)
    vals = data["values"].astype(jnp.float32)
    rets = data["returns"].astype(jnp.float32)

    traj_scores = (
        jnp.mean(jnp.abs(adv).reshape(N, -1), axis=1)
        + jnp.mean(jnp.abs(vals - rets).reshape(N, -1), axis=1))
    traj_probs = jax.nn.softmax(traj_scores, axis=0)
    traj_weights = ((1.0 / N) / traj_probs)[:, None]

    # Replicate _ppo's PRNG threading: one gen_update_rnd for the sampler,
    # one per epoch for the permutation.
    sample_rnd, next_key = random.split(train_state.update_prng_key)
    valid_inds = random.choice(
        sample_rnd, N, shape=(MB,), replace=False, p=traj_probs)
    mb_rnd, _ = random.split(next_key)
    mb_inds = random.permutation(mb_rnd, valid_inds)[:MB]

    w = traj_weights[mb_inds]  # [MB, 1]
    gather = lambda x: jnp.swapaxes(x[mb_inds], 0, 1)  # -> [T, MB, 1]

    hp_algo = cfg.algo
    action_obj = jnp.mean(w * gather(adv))
    value_loss = jnp.mean(
        w * optax.l2_loss(gather(data["obs"]["vbase"]), gather(rets)))
    entropy = hp_algo.entropy_coef * jnp.mean(
        w * gather(data["obs"]["ent"]))

    loss = -action_obj + hp_algo.value_loss_coef * value_loss - entropy
    return loss, w


def test_importance_sampling_weights_per_trajectory():
    cfg = _make_cfg()
    policy_state, train_state, rollout_data = _make_states_and_data(cfg)

    expected_loss, w = _expected_importance_sampled_loss(
        cfg, train_state, rollout_data)
    # The correction weights must actually vary, otherwise this test
    # couldn't distinguish per-trajectory weighting from uniform.
    assert float(jnp.std(w)) > 1e-3

    _, _, metrics = _run_ppo(cfg, policy_state, train_state, rollout_data)
    got_loss = float(np.asarray(metrics.metrics["Loss"].mean)[0, 0])

    np.testing.assert_allclose(got_loss, float(expected_loss), rtol=1e-5)

    # And the weighted loss differs from the unweighted one — i.e. the
    # weights weren't silently averaged away (the mean(w)*mean(loss)
    # degeneration of the [T, mb, mb] broadcast bug).
    cfg_uniform = _make_cfg(importance_sample_trajectories=False,
                            importance_sample_num_minibatches=0)
    ps2, ts2, rd2 = _make_states_and_data(cfg_uniform)
    _, _, metrics_u = _run_ppo(cfg_uniform, ps2, ts2, rd2)
    got_uniform = float(np.asarray(metrics_u.metrics["Loss"].mean)[0, 0])
    assert abs(got_loss - got_uniform) > 1e-6


def test_filter_advantages_weight_shape():
    """The filter path's all-ones weights must also be [N, 1]; _ppo_update
    trace-asserts the shape, so finishing one update is the check."""
    cfg = _make_cfg(importance_sample_trajectories=False,
                    importance_sample_num_minibatches=0,
                    filter_advantages=True)
    policy_state, train_state, rollout_data = _make_states_and_data(cfg)
    _, _, metrics = _run_ppo(cfg, policy_state, train_state, rollout_data)
    loss = np.asarray(metrics.metrics["Loss"].mean)
    assert np.isfinite(loss).all()
