"""Competitive all-pairs eval_policies + PBT reward-hyperparameter plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from madrona_learn_tpu.struct import FrozenDict

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env

from test_pbt_e2e import build_training_mgr, get_episode_scores, make_policy


@pytest.mark.slow
def test_eval_policies_competitive(tmp_path):
    """Save a PBT population, reload it, and run the all-pairs eval loop."""
    mgr = build_training_mgr(seed=41)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr = update(mgr)

    ckpt_dir = str(tmp_path / "ck")
    mgr.save_ckpt(ckpt_dir)

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    policy = make_policy(actions)

    policy_states, num_policies = mlt.eval_load_ckpt(
        policy, f"{ckpt_dir}/1", train_only=True)
    assert num_policies == 4

    num_worlds = 36  # nteams*team_size=2 agents; 36 match slots >= 16 pairs
    env_cfg = ToyEnvConfig(
        num_worlds=num_worlds, episode_len=8, num_teams=2, team_size=1,
        seed=7)
    sim_fns = make_duel_env(env_cfg)

    eval_cfg = mlt.EvalConfig(
        num_worlds=num_worlds,
        num_teams=2,
        team_size=1,
        num_eval_steps=16,
        actions=actions,
        reward_gamma=0.99,
        policy_dtype=jnp.float32,
        eval_competitive=True,
        use_deterministic_policy=False,
        clear_fitness=True,
    )

    def step_cb(step_data):
        return step_data["sim_state"]

    result = mlt.eval_policies(
        None, eval_cfg, sim_fns, policy,
        init_sim_ctrl=jnp.zeros((1,), jnp.int32),
        policy_states=policy_states,
        step_cb=step_cb,
    )
    # Competitive eval returns the MMR pytree.
    assert hasattr(result, "elo")
    assert np.isfinite(np.asarray(result.elo)).all()


@pytest.mark.slow
def test_reward_hyper_params_reach_sim_and_mutate():
    """reward_hyper_params flow into the sim step and get explored by PBT."""
    num_worlds = 32
    num_train = 4
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    env_cfg = ToyEnvConfig(
        num_worlds=num_worlds, episode_len=8, num_teams=2, team_size=1,
        seed=3)
    base = make_duel_env(env_cfg)

    seen = {}

    def step_fn(step_input):
        # The trainer must pass per-policy reward hyperparams to the sim.
        rhp = step_input["pbt"]["reward_hyper_params"]
        seen["shape"] = rhp.shape
        out = base["step"](step_input)
        # Scale rewards by each agent's policy's hyperparam.
        assignments = step_input["pbt"]["policy_assignments"].reshape(-1)
        scale = rhp[jnp.clip(assignments, 0, rhp.shape[0] - 1), 0][:, None]
        out["rewards"] = out["rewards"] * scale
        return out

    sim_fns = {"init": base["init"], "step": step_fn}

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=2,
        num_updates=1,
        actions=actions,
        steps_per_update=8,
        num_bptt_chunks=1,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=3,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=10,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        pbt=mlt.PBTConfig(
            num_teams=2,
            team_size=1,
            num_train_policies=num_train,
            num_past_policies=2,
            self_play_portion=0.25,
            cross_play_portion=0.5,
            past_play_portion=0.25,
            reward_hyper_params_explore=FrozenDict({
                "reward_scale": mlt.ParamExplore(
                    base=1.0, min_scale=0.5, max_scale=2.0),
            }),
        ),
        dreamer_v3_critic=False,
        compute_advantages=True,
    )

    policy = make_policy(actions)
    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))

    # init sampled per-policy hyperparams in [0.5, 2.0], differing by policy.
    rhp = np.asarray(mgr.state.policy_states.reward_hyper_params)
    assert rhp.shape == (num_train + 2, 1)
    train_rhp = rhp[:num_train, 0]
    assert (train_rhp >= 0.5 - 1e-6).all() and (train_rhp <= 2.0 + 1e-6).all()
    assert len(np.unique(train_rhp)) > 1

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr = update(mgr)
    assert seen["shape"][0] == num_train + 2  # sim saw the stacked params

    loss = np.asarray(jax.device_get(mgr.metrics.metrics["Loss"].mean))
    assert np.isfinite(loss).all()
