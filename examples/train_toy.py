"""Minimal single-policy PPO training on the toy gridworld.

Run: python examples/train_toy.py [--num-updates N] [--native-sim]
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu.models import (
    ActorCritic,
    BackboneShared,
    DenseLayerDiscreteActor,
    DictActor,
    DreamerV3Critic,
    LSTM,
    MLP,
    RecurrentBackboneEncoder,
)
from madrona_learn_tpu.utils.platform import (
    compute_dtype,
    use_checkout_compile_cache,
)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-updates", type=int, default=50)
    parser.add_argument("--num-worlds", type=int, default=1024)
    parser.add_argument("--native-sim", action="store_true")
    parser.add_argument("--ckpt-dir", type=str, default=None)
    parser.add_argument("--tb-dir", type=str, default=None)
    args = parser.parse_args()

    use_checkout_compile_cache()
    dtype = compute_dtype()

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}

    if args.native_sim:
        from madrona_learn_tpu.envs.native_sim import (
            NativeSimConfig,
            make_native_sim,
        )

        sim_fns = make_native_sim(NativeSimConfig(
            num_worlds=args.num_worlds, episode_len=40, grid_size=8))
    else:
        sim_fns = make_toy_env(ToyEnvConfig(
            num_worlds=args.num_worlds, episode_len=40, grid_size=8))

    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=256, num_layers=2, dtype=dtype),
                rnn=LSTM(num_hidden_channels=256, num_layers=1, dtype=dtype),
            ),
        ),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype),
        }),
        critic=DreamerV3Critic(dtype=dtype),
    )
    policy = mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype),
    )

    cfg = mlt.TrainConfig(
        num_worlds=args.num_worlds,
        num_agents_per_world=1,
        num_updates=args.num_updates,
        actions=actions,
        steps_per_update=40,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=10,
        algo=mlt.PPOConfig(
            num_epochs=2,
            minibatch_size=(2 * args.num_worlds) // 2,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        dreamer_v3_critic=True,
        compute_dtype=dtype,
    )

    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))

    tb_writer = mlt.TensorboardWriter(args.tb_dir) if args.tb_dir else None

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)

    start = time.perf_counter()
    for i in range(args.num_updates):
        mgr = update(mgr)
        if (i + 1) % 10 == 0:
            m = jax.device_get(mgr.metrics.metrics["Rewards"])
            print(f"update {i + 1}: mean reward "
                  f"{float(np.asarray(m.mean).reshape(-1)[0]):.3f}")
            if tb_writer is not None:
                mgr.log_metrics_tensorboard(tb_writer)

    jax.block_until_ready(mgr.state.train_states.opt_state)
    elapsed = time.perf_counter() - start
    steps = args.num_worlds * cfg.steps_per_update * args.num_updates
    print(f"{steps / elapsed:,.0f} env-steps/s")

    if args.ckpt_dir:
        mgr.save_ckpt(args.ckpt_dir)
        print(f"saved checkpoint to {args.ckpt_dir}")


if __name__ == "__main__":
    main()
