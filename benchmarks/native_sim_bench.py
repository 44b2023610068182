"""Simulator-bridge tax: pure-JAX env vs C++ host-callback vs C++ XLA-FFI.

Runs the identical training loop (same model/config) against the three env
backends and reports env-steps/s, quantifying what an external CPU-side
Madrona-style engine costs relative to an in-graph env — the number an
integrator needs when budgeting a real simulator port.

On a GPU the host-callback path round-trips device<->host every sim step
(the FFI path is CPU-only); on CPU they measure raw callback overhead.

Run: python benchmarks/native_sim_bench.py [--num-worlds 4096] [--updates 5]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from madrona_learn_tpu.utils.platform import compute_dtype
import numpy as np


def build_mgr(sim_fns, num_worlds, dtype):
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.models import (
        ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, LSTM, MLP,
        RecurrentBackboneEncoder)

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=256, num_layers=2, dtype=dtype),
                rnn=LSTM(num_hidden_channels=256, num_layers=1,
                         dtype=dtype))),
        actor=DictActor(heads={"move": DenseLayerDiscreteActor(
            cfg=actions["move"], dtype=dtype)}),
        critic=DenseLayerCritic(dtype=dtype))
    policy = mlt.Policy(
        actor_critic=ac,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=1, num_updates=5,
        actions=actions, steps_per_update=32, num_bptt_chunks=2, lr=1e-3,
        gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1, minibatch_size=(2 * num_worlds) // 4,
            clip_coef=0.2, value_loss_coef=0.5, entropy_coef=0.01,
            max_grad_norm=0.5),
        dreamer_v3_critic=False, compute_dtype=dtype)
    return mlt.init_training(None, cfg, sim_fns, policy,
                             init_sim_ctrl=jnp.zeros((1,), jnp.int32))


def bench_backend(name, sim_fns, num_worlds, updates, dtype):
    mgr = build_mgr(sim_fns, num_worlds, dtype)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr = update(mgr)
    jax.device_get(mgr.metrics.metrics["Loss"].mean)
    t0 = time.perf_counter()
    for _ in range(updates):
        mgr = update(mgr)
    jax.device_get(mgr.metrics.metrics["Loss"].mean)
    dt = time.perf_counter() - t0
    rate = num_worlds * 32 * updates / dt
    print(f"  {name}: {rate:,.0f} env-steps/s", flush=True)
    return rate


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-worlds", type=int, default=4096)
    parser.add_argument("--updates", type=int, default=5)
    args = parser.parse_args()

    from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
    from madrona_learn_tpu.envs.native_sim import (
        NativeSimConfig, make_native_sim)

    backend = jax.default_backend()
    dtype = compute_dtype()
    print(f"backend={backend} num_worlds={args.num_worlds}")

    rates = {}
    rates["pure-jax"] = bench_backend(
        "pure-JAX toy env", make_toy_env(ToyEnvConfig(
            num_worlds=args.num_worlds, episode_len=40, grid_size=8)),
        args.num_worlds, args.updates, dtype)

    rates["callback"] = bench_backend(
        "C++ host-callback", make_native_sim(NativeSimConfig(
            num_worlds=args.num_worlds, episode_len=40, grid_size=8)),
        args.num_worlds, args.updates, dtype)

    try:
        from madrona_learn_tpu.envs.native_sim_ffi import make_native_sim_ffi
        rates["ffi"] = bench_backend(
            "C++ XLA-FFI custom call", make_native_sim_ffi(NativeSimConfig(
                num_worlds=args.num_worlds, episode_len=40, grid_size=8)),
            args.num_worlds, args.updates, dtype)
    except Exception as e:  # FFI target registration is backend-dependent
        print(f"  C++ XLA-FFI: skipped ({type(e).__name__}: {e})",
              flush=True)

    base = rates["pure-jax"]
    for k, v in rates.items():
        if k != "pure-jax":
            print(f"  bridge tax ({k}): {v / base:.3f}x of in-graph env",
                  flush=True)


if __name__ == "__main__":
    main()
