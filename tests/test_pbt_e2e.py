"""PBT end-to-end: population training on the duel env with Elo + evolution.

Exercises the full stack the reference drives through train.py:397-574 —
population init with hyperparameter sampling, complex matchmaking rollouts,
vmapped per-policy PPO, in-loop Elo tournaments, and cull/past population
updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from madrona_learn_tpu.struct import FrozenDict

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu.models import (
    ActorCritic,
    BackboneEncoder,
    BackboneShared,
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DictActor,
    MLP,
)

NUM_TRAIN = 4
NUM_PAST = 2
NUM_WORLDS = 32
TEAM_SIZE = 1
EPISODE_LEN = 8


def get_episode_scores(episode_result):
    """Map per-world winning team -> (team-a score, team-b score)."""
    winner = episode_result[0]
    a_score = jnp.where(winner == 0, 1.0, jnp.where(winner == 1, 0.0, 0.5))
    return a_score, 1.0 - a_score


def make_policy(actions):
    dtype = jnp.float32
    backbone = BackboneShared(
        prefix=lambda obs, train: jnp.concatenate(
            [obs["time"], obs["acc"]], axis=-1),
        encoder=BackboneEncoder(
            net=MLP(num_channels=32, num_layers=1, dtype=dtype)),
    )
    actor_critic = ActorCritic(
        backbone=backbone,
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype),
        }),
        critic=DenseLayerCritic(dtype=dtype),
    )
    return mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
        get_episode_scores=get_episode_scores,
    )


def build_training_mgr(seed=3, mesh=None, normalize_values=False):
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    env_cfg = ToyEnvConfig(
        num_worlds=NUM_WORLDS, episode_len=EPISODE_LEN, num_teams=2,
        team_size=TEAM_SIZE, seed=seed)
    sim_fns = make_duel_env(env_cfg)

    cfg = mlt.TrainConfig(
        num_worlds=NUM_WORLDS,
        num_agents_per_world=2 * TEAM_SIZE,
        num_updates=4,
        actions=actions,
        steps_per_update=16,
        num_bptt_chunks=2,
        lr=mlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99,
        gae_lambda=0.95,
        seed=seed,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            # sequences/policy = num_bptt_chunks * train agents/policy = 20
            minibatch_size=10,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        pbt=mlt.PBTConfig(
            num_teams=2,
            team_size=TEAM_SIZE,
            num_train_policies=NUM_TRAIN,
            num_past_policies=NUM_PAST,
            self_play_portion=0.25,
            cross_play_portion=0.5,
            past_play_portion=0.25,
            policy_overwrite_threshold=0.5,
        ),
        dreamer_v3_critic=False,
        normalize_values=normalize_values,
        compute_advantages=True,
        mesh=mesh,
    )

    policy = make_policy(actions)
    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    return mgr


@pytest.mark.slow
def test_pbt_population_trains_and_evolves():
    mgr = build_training_mgr()

    # Population init: per-policy hyperparams were sampled from the explore
    # space (so lrs differ across policies).
    lrs = np.asarray(mgr.state.train_states.hyper_params.lr)
    assert lrs.shape == (NUM_TRAIN,)
    assert len(np.unique(lrs)) > 1
    assert (lrs >= 1e-4 - 1e-9).all() and (lrs <= 1e-2 + 1e-9).all()

    # Elo state exists for competitive matchmaking.
    assert mgr.state.policy_states.mmr is not None
    assert mgr.state.policy_states.mmr.elo.shape == (NUM_TRAIN + NUM_PAST,)

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    for _ in range(3):
        mgr = update(mgr)

    loss = np.asarray(mgr.metrics.metrics["Loss"].mean)
    assert np.isfinite(loss).all()
    assert int(mgr.update_idx) == 3

    # In-loop Elo tournament.
    mgr, elo_deltas = jax.jit(
        lambda m: mlt.eval_elo(
            m, num_eval_steps=2 * EPISODE_LEN,
            eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
            train_sim_ctrl=jnp.zeros((1,), jnp.int32)),
    )(mgr)
    elos = np.asarray(mgr.state.policy_states.mmr.elo)
    assert elos.shape == (NUM_TRAIN + NUM_PAST,)
    assert np.isfinite(elos).all()
    # Re-baselined: baseline policy sits at exactly 1500.
    assert abs(elos[0] - 1500.0) < 1e-3

    # Population evolution (cull + past snapshot) runs under jit.
    mgr = jax.jit(mlt.update_population)(mgr)
    assert np.isfinite(
        np.asarray(mgr.state.train_states.hyper_params.lr)).all()

    # Matchmaking portions restored for training after eval_elo.
    assert mgr.rollout.cfg.pbt.self_play_portion == 0.25


@pytest.mark.slow
def test_pbt_update_deterministic():
    mgr_a = build_training_mgr(seed=9)
    mgr_b = build_training_mgr(seed=9)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr_a = update(mgr_a)
    mgr_b = update(mgr_b)
    la = np.asarray(mgr_a.metrics.metrics["Loss"].mean)
    lb = np.asarray(mgr_b.metrics.metrics["Loss"].mean)
    np.testing.assert_array_equal(la, lb)
