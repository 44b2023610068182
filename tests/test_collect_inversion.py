"""Full RolloutManager.collect store-inversion oracle.

The collect path stores trajectories as ``[C, T/C, P, B]`` then finalizes to
per-policy training sequences ``[P, C*B, T/C]`` with cached RNN start
states. This test (reference analog: tests/test_rollouts.py:611-757) runs
collect with the integer-exact fake sim/policy and validates every stored
sequence *internally* against the fake recurrence:

- policy identity: each of policy p's sequences was produced by p's params;
- RNN state chain: starting from the cached ``rnn_start_states``, actions
  and values follow the integer recurrence bit-exactly through the sequence
  (so BPTT chunking, the store reshape, and RNN caching all agree);
- rewards = action + 2, done flags follow the episode clock;
- sequence count per policy matches the train-agent geometry.

This validates the ``[C,T/C,P,B] -> [P,C*B,T/C]`` reorder and its RNN
alignment without replaying matchmaking PRNG decisions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from madrona_learn_tpu.struct import FrozenDict
from jax import random

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs.fake_sim import FakeSimConfig, make_fake_sim
from madrona_learn_tpu.ops.metrics import TrainingMetrics
from madrona_learn_tpu.rollouts import (
    RolloutConfig,
    RolloutManager,
    RolloutState,
)
from madrona_learn_tpu.train_state import PolicyTrainState, TrainStateManager

from test_rollouts import build_fake_policy_states


def _run_collect(num_current, num_past, num_teams, team_size, batch,
                 self_p, cross_p, past_p, episode_len, steps_per_update,
                 num_bptt_chunks, chunk_override=0, seed=11):
    rollout_cfg = RolloutConfig.setup(
        num_current_policies=num_current,
        num_past_policies=num_past,
        num_teams=num_teams,
        team_size=team_size,
        sim_batch_size=batch,
        actions_cfg={"fake": None},
        self_play_portion=self_p,
        cross_play_portion=cross_p,
        past_play_portion=past_p,
        static_play_portion=0.0,
        policy_dtype=jnp.int32,
        reward_dtype=jnp.int32,
        policy_chunk_size_override=chunk_override,
    )
    sim_fns = make_fake_sim(FakeSimConfig(
        batch_size=batch, episode_len=episode_len, num_teams=num_teams,
        team_size=team_size))

    policy_states, actor_critic = build_fake_policy_states(rollout_cfg)

    train_cfg = mlt.TrainConfig(
        num_worlds=batch // (num_teams * team_size),
        num_agents_per_world=num_teams * team_size,
        num_updates=1,
        actions={"fake": mlt.DiscreteActionsConfig(actions_num_buckets=[1])},
        steps_per_update=steps_per_update,
        num_bptt_chunks=num_bptt_chunks,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=seed,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1, minibatch_size=1, clip_coef=0.2,
            value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False,
        compute_advantages=False,  # integer rewards; returns path
        normalize_values=False,
    )

    num_train = rollout_cfg.pbt.num_current_policies

    def stack_none(_):
        return None

    train_states = PolicyTrainState(
        value_normalizer=None,
        max_advantage_est=None,
        tx=None,
        initial_weight_norms=None,
        value_normalizer_state=None,
        max_advantage_est_state=None,
        hyper_params=None,
        opt_state=None,
        scaler=None,
        update_prng_key=random.split(random.key(seed), num_train),
    )
    mgr_state = TrainStateManager(
        policy_states=policy_states,
        train_states=train_states,
        pbt_rng=random.key(seed + 1),
        user_state=None,
    )

    @jax.jit
    def run():
        rollout_state = RolloutState.create(
            rollout_cfg=rollout_cfg,
            sim_fns=sim_fns,
            prng_key=random.PRNGKey(seed),
            rnn_states=actor_critic.init_recurrent_state(batch),
            init_sim_ctrl=jnp.zeros((1,), jnp.int32),
        )
        rollout_mgr = RolloutManager(train_cfg, rollout_state, policy_states)
        metrics = TrainingMetrics.create(
            rollout_mgr.add_metrics(train_cfg, FrozenDict({})),
            buffer_size=1, start_update_idx=0, num_policies=num_train)

        start_hook = lambda rs, us: (rs, us)
        finish_hook = lambda r, bv, uv, ubv, us: (r, us)
        metrics_hook = lambda m, r, us: m

        (mgr_state2, rollout_state, rollout_data, obs_stats,
         metrics) = rollout_mgr.collect(
            mgr_state, rollout_state, metrics,
            start_hook, finish_hook, metrics_hook)
        return rollout_data, metrics

    rollout_data, metrics = run()
    return (rollout_cfg, train_cfg,
            jax.tree.map(np.asarray, jax.device_get(rollout_data.data)),
            rollout_data)


def _verify_store(rollout_cfg, train_cfg, data, episode_len):
    """Numpy oracle over the finalized [P, C*B, T/C] store."""
    P = rollout_cfg.pbt.num_current_policies
    actions = data["actions"]["fake"]          # [P, S, T, 3]
    values = data["values"]                    # [P, S, T, 1]
    rewards = data["rewards"]                  # [P, S, T, 1]
    dones = data["dones"]                      # [P, S, T, 1]
    obs_o = data["obs"]["o"]                   # [P, S, T, 1]
    obs_c = data["obs"]["c"]                   # [P, S, T, 1]
    rnn_start = data["rnn_start_states"]       # [P, S, ...]

    S, T = actions.shape[1], actions.shape[2]
    np.seterr(over="ignore")

    for p in range(P):
        # Policy identity: every sequence stored for policy p used p's bias.
        np.testing.assert_array_equal(
            actions[p, :, :, 1], np.full((S, T), p, np.int32),
            err_msg=f"policy {p} identity")

        h = rnn_start[p].reshape(S).astype(np.int32).copy()
        for t in range(T):
            o = obs_o[p, :, t, 0].astype(np.int32)
            c = obs_c[p, :, t, 0].astype(np.int32)
            x0 = o + np.int32(p)
            y = x0 + h
            new_h = h + np.int32(2) * x0

            np.testing.assert_array_equal(
                actions[p, :, t, 0], y, err_msg=f"p={p} t={t} action y")
            np.testing.assert_array_equal(
                actions[p, :, t, 2], c, err_msg=f"p={p} t={t} action c")
            np.testing.assert_array_equal(
                values[p, :, t, 0], new_h, err_msg=f"p={p} t={t} value")
            np.testing.assert_array_equal(
                rewards[p, :, t, 0], y + 2, err_msg=f"p={p} t={t} reward")

            expected_done = ((c + 1) % episode_len) == 0
            np.testing.assert_array_equal(
                dones[p, :, t, 0].astype(bool), expected_done,
                err_msg=f"p={p} t={t} done")

            h = np.where(expected_done, 0, new_h)


CONFIGS = [
    # (n_cur, n_past, teams, team_size, batch, self, cross, past,
    #  episode_len, steps, bptt_chunks, chunk_override)
    (1, 0, 1, 1, 16, 1.0, 0.0, 0.0, 3, 8, 2, 0),
    (4, 0, 2, 1, 64, 0.5, 0.5, 0.0, 4, 8, 2, 8),
    (4, 2, 2, 1, 64, 0.5, 0.25, 0.25, 5, 12, 3, 8),
    (8, 7, 2, 2, 256, 0.25, 0.5, 0.25, 7, 8, 2, 16),
]


@pytest.mark.parametrize("cfg_tuple", CONFIGS)
def test_collect_store_inversion(cfg_tuple):
    (n_cur, n_past, teams, team_size, batch, self_p, cross_p, past_p,
     episode_len, steps, chunks, chunk_override) = cfg_tuple

    rollout_cfg, train_cfg, data, rollout_data = _run_collect(
        n_cur, n_past, teams, team_size, batch, self_p, cross_p, past_p,
        episode_len, steps, chunks, chunk_override)

    # Geometry: C*B sequences per policy of length T/C.
    assert data["dones"].shape[1] == rollout_data.num_train_seqs_per_policy
    assert data["dones"].shape[2] == steps // chunks

    _verify_store(rollout_cfg, train_cfg, data, episode_len)


@pytest.mark.slow
@pytest.mark.parametrize("cfg_tuple", [
    # Reference-scale configs (reference: tests/test_rollouts.py:779-793):
    # large batches where partial-chunk padding and the pow2 heuristics bite.
    (16, 7, 2, 2, 16384, 0.25, 0.5, 0.25, 7, 8, 2, 0),
    (16, 0, 2, 1, 16384, 0.5, 0.5, 0.0, 5, 8, 2, 0),
    (8, 7, 4, 4, 8192, 0.25, 0.25, 0.5, 6, 8, 2, 0),
])
def test_collect_store_inversion_large(cfg_tuple):
    test_collect_store_inversion(cfg_tuple)
