"""Rollout-pass vs update-pass forward consistency.

PPO's importance ratio must start at exactly 1: the log-probs the update
pass (sequence scan over stored obs/actions) computes with unchanged weights
must match the log-probs recorded during rollouts, and the LSTM sequence
scan must reproduce the step-by-step recurrent states including done-masked
clears. These invariants gate the whole BPTT data layout
([C,T/C,P,B] -> [P,C*B,T/C] and its time-major minibatch transpose).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import random

from madrona_learn_tpu.models import LSTM


def test_lstm_sequence_matches_stepwise():
    dtype = jnp.float32
    N, T, H, F = 6, 12, 16, 8
    lstm = LSTM(num_hidden_channels=H, num_layers=2, dtype=dtype)

    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(T, N, F)), dtype)
    dones = jnp.asarray(rng.random((T, N, 1)) < 0.2)

    init_state = lstm.init_recurrent_state(N)
    params = lstm.init(random.PRNGKey(0), init_state, xs[0], False)

    # Step-by-step: apply cell, then clear on done (same order as the
    # rollout engine: step, then reset when the sim reports done).
    state = init_state
    outs = []
    for t in range(T):
        out, state = lstm.apply(params, state, xs[t], False)
        state = lstm.clear_recurrent_state(state, dones[t])
        outs.append(out)
    stepwise = jnp.stack(outs)

    seq_out = lstm.apply(
        params, init_state, dones, xs, False, method="sequence")

    np.testing.assert_allclose(
        np.asarray(stepwise), np.asarray(seq_out), rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_update_log_probs_match_rollout():
    """Collected log-probs == update-pass log-probs at unchanged weights."""
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
    from test_train_e2e import make_policy

    num_worlds = 16
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=10, grid_size=5, seed=8))

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        num_updates=1,
        actions=actions,
        steps_per_update=8,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.95,
        gae_lambda=0.95,
        seed=8,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=2 * num_worlds,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        dreamer_v3_critic=False,
        compute_advantages=True,
    )

    policy = make_policy(actions, recurrent=True)
    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))

    # Collect one batch of rollouts without optimizing.
    from madrona_learn_tpu.rollouts import RolloutManager
    from madrona_learn_tpu.train import TrainHooks

    hooks = TrainHooks()
    rollout_mgr = RolloutManager(
        train_cfg=cfg,
        init_rollout_state=mgr.rollout,
        example_policy_states=mgr.state.policy_states,
    )

    @jax.jit
    def collect(state_mgr, rollout_state, metrics):
        return rollout_mgr.collect(
            state_mgr, rollout_state, metrics,
            hooks.start_rollouts, hooks.finish_rollouts,
            hooks.rollout_metrics)

    (state_mgr, rollout_state, rollout_data, obs_stats, metrics) = collect(
        mgr.state, mgr.rollout, mgr.metrics)

    # Re-run the update-pass forward per policy at the same weights.
    @jax.jit
    @jax.vmap
    def update_fwd(policy_state, data):
        # data leaves: [num_seqs, T/C, ...]; time-major like minibatch(),
        # except rnn_start_states (no time axis).
        data, rnn_start = data.pop("rnn_start_states")
        mb = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), data)
        return policy_state.apply_fn(
            {"params": policy_state.params,
             "batch_stats": policy_state.batch_stats},
            rnn_start,
            mb["dones"],
            mb["actions"],
            mb["obs"],
            train=False,
            method="update",
        )

    data = rollout_data.all()
    fwd = update_fwd(state_mgr.policy_states, data)

    recorded = data["log_probs"]["move"]  # [P, num_seqs, T/C, 1]
    recomputed = jnp.swapaxes(fwd["log_probs"]["move"], 1, 2)

    np.testing.assert_allclose(
        np.asarray(recomputed), np.asarray(recorded), rtol=1e-4, atol=1e-5)


def test_actor_only_path():
    """actor_only: deterministic greedy actions, critic tower untouched."""
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.models import (
        ActorCritic, BackboneSeparate, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, LSTM, MLP,
        RecurrentBackboneEncoder,
    )
    from madrona_learn_tpu.struct import FrozenDict

    dtype = jnp.float32
    actions_cfg = mlt.DiscreteActionsConfig(actions_num_buckets=[5])

    def make_enc():
        return RecurrentBackboneEncoder(
            net=MLP(num_channels=16, num_layers=1, dtype=dtype),
            rnn=LSTM(num_hidden_channels=8, num_layers=1, dtype=dtype))

    ac = ActorCritic(
        backbone=BackboneSeparate(
            prefix=lambda obs, train: obs["x"],
            actor_encoder=make_enc(),
            critic_encoder=make_enc()),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions_cfg, dtype=dtype)}),
        critic=DenseLayerCritic(dtype=dtype),
    )

    N = 4
    obs = FrozenDict({"x": jnp.ones((N, 6), dtype)})
    rnn = ac.init_recurrent_state(N)
    params = ac.init(
        random.PRNGKey(0), random.PRNGKey(1), rnn, obs, method="rollout")

    out, new_rnn = ac.apply(params, rnn, obs, method="actor_only")
    assert out["actions"]["move"].shape == (N, 1)
    # Greedy: identical on repeat.
    out2, _ = ac.apply(params, rnn, obs, method="actor_only")
    np.testing.assert_array_equal(
        np.asarray(out["actions"]["move"]), np.asarray(out2["actions"]["move"]))
    # Critic tower state slot is untouched by actor_only.
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), new_rnn[1], rnn[1])
    # Actor tower state advanced.
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool((np.asarray(a) != np.asarray(b)).any()),
        new_rnn[0], rnn[0]))
    assert any(moved)


def test_gru_sequence_matches_stepwise():
    from madrona_learn_tpu.models import GRU

    dtype = jnp.float32
    N, T, H, F = 6, 12, 16, 8
    gru = GRU(num_hidden_channels=H, num_layers=2, dtype=dtype)

    rng = np.random.default_rng(1)
    xs = jnp.asarray(rng.normal(size=(T, N, F)), dtype)
    dones = jnp.asarray(rng.random((T, N, 1)) < 0.2)

    init_state = gru.init_recurrent_state(N)
    params = gru.init(random.PRNGKey(0), init_state, xs[0], False)

    state = init_state
    outs = []
    for t in range(T):
        out, state = gru.apply(params, state, xs[t], False)
        state = gru.clear_recurrent_state(state, dones[t])
        outs.append(out)
    stepwise = jnp.stack(outs)

    seq_out = gru.apply(
        params, init_state, dones, xs, False, method="sequence")

    np.testing.assert_allclose(
        np.asarray(stepwise), np.asarray(seq_out), rtol=1e-5, atol=1e-5)


def test_gru_trains_e2e():
    """GRU as the backbone RNN: rewards rise on the toy env."""
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
    from madrona_learn_tpu.models import (
        ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, GRU, MLP,
        RecurrentBackboneEncoder)

    num_worlds = 64
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=20, grid_size=6, seed=9))

    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=64, num_layers=1, dtype=jnp.float32),
                rnn=GRU(num_hidden_channels=64, num_layers=1,
                        dtype=jnp.float32))),
        actor=DictActor(heads={"move": DenseLayerDiscreteActor(
            cfg=actions["move"], dtype=jnp.float32)}),
        critic=DenseLayerCritic(dtype=jnp.float32))
    policy = mlt.Policy(
        actor_critic=ac,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=jnp.float32))

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=1, num_updates=15,
        actions=actions, steps_per_update=20, num_bptt_chunks=2, lr=1e-3,
        gamma=0.99, gae_lambda=0.95, seed=6, metrics_buffer_size=5,
        algo=mlt.PPOConfig(
            num_epochs=2, minibatch_size=32, clip_coef=0.2,
            value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False)

    mgr = mlt.init_training(None, cfg, sim_fns, policy,
                            init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    first = None
    for i in range(cfg.num_updates):
        mgr = update(mgr)
        if i == 2:
            first = float(np.nanmean(np.asarray(
                jax.device_get(mgr.metrics.metrics["Rewards"].mean))))
    last = float(np.nanmean(np.asarray(
        jax.device_get(mgr.metrics.metrics["Rewards"].mean))))
    assert last > first, (first, last)
