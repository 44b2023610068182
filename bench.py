"""Benchmark: aggregate PPO throughput (env-steps/s) on one GPU.

Methodology mirrors the reference's ac_test (reference: tests/ac_test.py:
355-369): compile the full resident update step (rollout collection + GAE +
minibatched PPO), run one warmup update, then time updates and report
env-steps/s. The env is the pure-JAX toy gridworld so the number measures
the framework (inference + trajectory machinery + learner), not an external
simulator. The model: a 2x256 MLP into a 256-wide LSTM in bf16, 16,384
worlds, 32 steps per update in 2 BPTT chunks.

Prints ONE JSON line naming the device it ran on. Exits non-zero, printing
no result, when JAX finds no GPU.

Run: python bench.py
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

NUM_WORLDS = 16384
STEPS_PER_UPDATE = 32
NUM_BPTT_CHUNKS = 2
CHANNELS = 256
TIMED_UPDATES = 10


def build_actor_critic(dtype):
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.models import (
        ActorCritic,
        BackboneShared,
        DenseLayerCritic,
        DenseLayerDiscreteActor,
        DictActor,
        LSTM,
        MLP,
        RecurrentBackboneEncoder,
    )

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=CHANNELS, num_layers=2, dtype=dtype),
                rnn=LSTM(num_hidden_channels=CHANNELS, num_layers=1,
                         dtype=dtype),
            ),
        ),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype),
        }),
        critic=DenseLayerCritic(dtype=dtype),
    )
    return actor_critic, actions


def build_manager(dtype, num_worlds=NUM_WORLDS):
    """The headline training manager, initialized on the default device."""
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env

    env_cfg = ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8, seed=0,
        reward_dtype=jnp.float32)
    sim_fns = make_toy_env(env_cfg)

    actor_critic, actions = build_actor_critic(dtype)
    policy = mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype),
    )

    cfg = mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        num_updates=TIMED_UPDATES,
        actions=actions,
        steps_per_update=STEPS_PER_UPDATE,
        num_bptt_chunks=NUM_BPTT_CHUNKS,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=(NUM_BPTT_CHUNKS * num_worlds) // 4,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        dreamer_v3_critic=False,
        normalize_values=False,
        compute_advantages=True,
        compute_dtype=dtype,
    )
    return mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))


def gpu_name_and_power_limit():
    """``name, power.limit`` of the first GPU as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_record():
    """Platform, device kind and count as JAX reports them; raises when
    JAX found no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main():
    from madrona_learn_tpu.utils.platform import use_checkout_compile_cache

    device = device_record()
    use_checkout_compile_cache()
    mgr = build_manager(jnp.bfloat16)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)

    t0 = time.perf_counter()
    mgr = update(mgr)
    jax.block_until_ready(mgr)
    warmup_s = time.perf_counter() - t0

    # Three timed trials; each reports its own rate.
    rates = []
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(TIMED_UPDATES):
            mgr = update(mgr)
        jax.block_until_ready(mgr)
        elapsed = time.perf_counter() - start
        rates.append(NUM_WORLDS * STEPS_PER_UPDATE * TIMED_UPDATES / elapsed)

    print(json.dumps({
        "metric": "ppo_env_steps_per_s_per_chip",
        "value": max(rates),
        "trials": rates,
        "unit": "env-steps/s",
        "warmup_update_s": warmup_s,
        "device": device,
        "gpu": gpu_name_and_power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
