"""BASELINE.json five-config benchmark suite, one process.

Measures env-steps/s per chip and updates/s for each of the driver's five
configs (BASELINE.json:6-12) with the AOT-compile-then-time methodology
(reference: tests/ac_test.py:355-369), and records the result table to
artifacts/configs_bench.json:

  #1 MLP actor-critic PPO, toy env            (measured)
  #2 LSTM PPO + value norm + EMA stats, 4k    (measured)
  #3 self-play multi-agent PPO, 16k envs      (measured)
  #4 PBT population of 8 w/ mutation + swaps  (measured, incl. one
     eval_elo tournament + update_population cycle)
  #5 multi-host 32-policy PBT over 64k envs   (no pod here: records the
     8-virtual-device dryrun result; the 2-process sharded train +
     collective checkpoint path is tests/test_multiprocess.py)

Run: python benchmarks/configs_bench.py  (GPU; CPU works for smoke)
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env, make_toy_env
from madrona_learn_tpu.models import (
    ActorCritic,
    BackboneEncoder,
    BackboneShared,
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DictActor,
    LSTM,
    MLP,
    RecurrentBackboneEncoder,
)
from madrona_learn_tpu.utils.platform import (
    compute_dtype,
    use_checkout_compile_cache,
)

CH = 256
TIMED = int(os.environ.get("CONFIGS_BENCH_TIMED", "10"))
# CPU smoke: divide world counts (e.g. CONFIGS_BENCH_DIV=64).
DIV = int(os.environ.get("CONFIGS_BENCH_DIV", "1"))


def _toy_policy(actions, dtype, recurrent, normalize_obs):
    net = MLP(num_channels=CH, num_layers=2, dtype=dtype)
    if recurrent:
        encoder = RecurrentBackboneEncoder(
            net=net,
            rnn=LSTM(num_hidden_channels=CH, num_layers=1, dtype=dtype))
    else:
        encoder = BackboneEncoder(net=net)
    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=encoder),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"],
                                            dtype=dtype)}),
        critic=DenseLayerCritic(dtype=dtype))
    obs_pre = (mlt.ObservationsEMANormalizer.create(decay=0.99999,
                                                    dtype=dtype)
               if normalize_obs else mlt.ObservationsCaster.create(
                   dtype=dtype))
    return mlt.Policy(actor_critic=ac, obs_preprocess=obs_pre)


def _duel_policy(actions, dtype):
    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["time"], obs["acc"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=CH, num_layers=2, dtype=dtype),
                rnn=LSTM(num_hidden_channels=CH, num_layers=1,
                         dtype=dtype))),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"],
                                            dtype=dtype)}),
        critic=DenseLayerCritic(dtype=dtype))
    return mlt.Policy(
        actor_critic=ac,
        obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
        get_episode_scores=lambda er: (
            jnp.where(er[0] == 0, 1.0, jnp.where(er[0] == 1, 0.0, 0.5)),
            jnp.where(er[0] == 0, 0.0, jnp.where(er[0] == 1, 1.0, 0.5))))


def _time_updates(mgr, num_worlds, agents_per_world, steps_per_update):
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr = update(mgr)
    jax.device_get(mgr.metrics.metrics["Loss"].mean)
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(TIMED):
            mgr = update(mgr)
        jax.device_get(mgr.metrics.metrics["Loss"].mean)
        dt = time.perf_counter() - t0
        best = max(best,
                   num_worlds * agents_per_world * steps_per_update
                   * TIMED / dt)
    return mgr, best, best / (num_worlds * agents_per_world
                              * steps_per_update)


def config1_mlp_toy():
    dtype = compute_dtype()
    num_worlds = 16384 // DIV
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8, seed=0,
        reward_dtype=jnp.float32))
    policy = _toy_policy(actions, dtype, recurrent=False,
                         normalize_obs=True)
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=1, num_updates=TIMED,
        actions=actions, steps_per_update=32, num_bptt_chunks=2,
        lr=1e-3, gamma=0.99, gae_lambda=0.95, seed=0,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(num_epochs=1, minibatch_size=num_worlds // 2,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False,
        compute_dtype=dtype)
    mgr = mlt.init_training(None, cfg, sim_fns, policy,
                            init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    _, rate, ups = _time_updates(mgr, num_worlds, 1, 32)
    return {"env_steps_per_s": rate, "updates_per_s": ups}


def config2_lstm_valuenorm_4k():
    dtype = compute_dtype()
    num_worlds = 4096 // DIV
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8, seed=1,
        reward_dtype=jnp.float32))
    policy = _toy_policy(actions, dtype, recurrent=True, normalize_obs=True)
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=1, num_updates=TIMED,
        actions=actions, steps_per_update=32, num_bptt_chunks=2,
        lr=1e-3, gamma=0.99, gae_lambda=0.95, seed=1,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(num_epochs=1, minibatch_size=num_worlds // 2,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        normalize_values=True,
        dreamer_v3_critic=False,
        compute_dtype=dtype)
    mgr = mlt.init_training(None, cfg, sim_fns, policy,
                            init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    _, rate, ups = _time_updates(mgr, num_worlds, 1, 32)
    return {"env_steps_per_s": rate, "updates_per_s": ups}


def pbt_manager(num_worlds, num_train, num_past, portions, seed,
                explore=False, dtype=None, mesh=None):
    """Duel-env PBT population (configs #3 and #4); ``mesh`` is the
    TrainConfig's MeshConfig."""
    dtype = dtype or compute_dtype()
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_duel_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=32, num_teams=2, team_size=1,
        seed=seed, reward_dtype=jnp.float32))
    policy = _duel_policy(actions, dtype)
    sim_batch = num_worlds * 2
    train_agents = int(sim_batch * (portions[0] + portions[1] / 2
                                    + portions[2] / 2)) // num_train
    lr = (mlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                           log10_scale=True) if explore else 1e-3)
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=2, num_updates=TIMED,
        actions=actions, steps_per_update=32, num_bptt_chunks=2,
        lr=lr, gamma=0.99, gae_lambda=0.95, seed=seed,
        metrics_buffer_size=1,
        # seqs/policy = num_bptt_chunks * train_agents; this always divides.
        algo=mlt.PPOConfig(num_epochs=1,
                           minibatch_size=train_agents,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        pbt=mlt.PBTConfig(
            num_teams=2, team_size=1,
            num_train_policies=num_train, num_past_policies=num_past,
            self_play_portion=portions[0],
            cross_play_portion=portions[1],
            past_play_portion=portions[2]),
        dreamer_v3_critic=False,
        compute_dtype=dtype,
        mesh=mesh)
    return mlt.init_training(None, cfg, sim_fns, policy,
                             init_sim_ctrl=jnp.zeros((1,), jnp.int32))


def config3_selfplay_16k():
    num_worlds = 8192 // DIV  # x2 agents = 16k agent batch
    mgr = pbt_manager(num_worlds, num_train=4, num_past=0,
                   portions=(0.5, 0.5, 0.0), seed=2)
    _, rate, ups = _time_updates(mgr, num_worlds, 2, 32)
    return {"agent_steps_per_s": rate, "updates_per_s": ups}


def config4_pbt8():
    num_worlds = 8192 // DIV
    mgr = pbt_manager(num_worlds, num_train=8, num_past=4,
                   portions=(0.25, 0.5, 0.25), seed=3, explore=True)
    mgr, rate, ups = _time_updates(mgr, num_worlds, 2, 32)

    # One full PBT outer-loop cycle: Elo tournament + cull/past update.
    t0 = time.perf_counter()
    mgr, deltas = mlt.eval_elo(
        mgr, num_eval_steps=32,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))
    mgr = mlt.update_population(mgr, deltas)
    jax.block_until_ready(mgr.state.policy_states.mmr.elo)
    elo_cycle_s = time.perf_counter() - t0
    return {"agent_steps_per_s": rate, "updates_per_s": ups,
            "elo_tournament_plus_evolve_s": elo_cycle_s}


def config5_multihost_dryrun():
    # The multi-host shape is validated for correctness on a virtual
    # 8-device CPU mesh (and across 2 real processes in
    # tests/test_multiprocess.py). The child is pinned to the CPU, so it
    # never opens the GPU this process holds.
    import subprocess
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); "
         "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        capture_output=True, text=True, env=env, timeout=900)
    ok = proc.returncode == 0
    if not ok:
        print(proc.stderr[-2000:], file=sys.stderr)
    return {"dryrun_8dev_ok": ok,
            "note": ("32-policy/64k-env shape validated for correctness "
                     "on virtual meshes (tests/test_sharding.py::"
                     "test_large_population_sharded_update) and across 2 "
                     "real processes (tests/test_multiprocess.py)")}


def main():
    use_checkout_compile_cache()
    dev = jax.devices()[0]
    results = {"platform": dev.platform, "device_kind": dev.device_kind,
               "device_count": len(jax.devices()),
               "methodology": "AOT warmup + best of 3 x 10 timed updates"}
    for name, fn in (
        ("config1_mlp_toy_ppo", config1_mlp_toy),
        ("config2_lstm_valuenorm_ema_4k", config2_lstm_valuenorm_4k),
        ("config3_selfplay_multiagent_16k", config3_selfplay_16k),
        ("config4_pbt8_mutation_swaps", config4_pbt8),
        ("config5_multihost_pbt", config5_multihost_dryrun),
    ):
        t0 = time.perf_counter()
        results[name] = fn()
        results[name]["wall_s"] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {json.dumps(results[name])}", flush=True)

    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/configs_bench.json", "w") as f:
        json.dump(results, f, indent=1)
    print("wrote artifacts/configs_bench.json")


if __name__ == "__main__":
    main()
