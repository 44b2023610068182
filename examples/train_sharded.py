"""Mesh-sharded PBT training: the full multi-chip recipe in one script.

Runs the complete multi-device stack: a (data x policy) mesh, PBT population
with cross/past-play matchmaking (shard-local reorder kicks in
automatically), sharded update step, periodic Elo tournaments, and async
checkpointing.

On one host with several GPUs, run it as one process. Across hosts, launch
one process per host after `jax.distributed` initialization
(parallel/distributed.py). Without several devices, exercise it on virtual
CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/train_sharded.py --data 4 --policy 2
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env
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
from madrona_learn_tpu.parallel import (
    distributed,
    make_mesh,
    shard_training_manager,
)
from madrona_learn_tpu.utils.platform import (
    compute_dtype,
    use_checkout_compile_cache,
)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=int, default=4)
    parser.add_argument("--policy", type=int, default=2)
    parser.add_argument("--num-worlds", type=int, default=256)
    parser.add_argument("--num-updates", type=int, default=12)
    parser.add_argument("--eval-interval", type=int, default=6)
    parser.add_argument("--ckpt-dir", type=str, default=None)
    args = parser.parse_args()

    distributed.init_multi_host()  # no-op off-cluster
    use_checkout_compile_cache()

    mesh_cfg = mlt.MeshConfig(data=args.data, policy=args.policy)
    mesh = make_mesh(mesh_cfg)
    print(f"mesh: {mesh}")

    num_train, num_past = 4, 2
    dtype = compute_dtype()

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_duel_env(ToyEnvConfig(
        num_worlds=args.num_worlds, episode_len=8, num_teams=2,
        team_size=1, seed=0))

    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["time"], obs["acc"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=64, num_layers=1, dtype=dtype),
                rnn=LSTM(num_hidden_channels=32, num_layers=1,
                         dtype=dtype))),
        actor=DictActor(heads={"move": DenseLayerDiscreteActor(
            cfg=actions["move"], dtype=dtype)}),
        critic=DenseLayerCritic(dtype=dtype))
    policy = mlt.Policy(
        actor_critic=ac,
        obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
        get_episode_scores=lambda er: (
            jnp.where(er[0] == 0, 1.0, jnp.where(er[0] == 1, 0.0, 0.5)),
            jnp.where(er[0] == 0, 0.0, jnp.where(er[0] == 1, 1.0, 0.5))))

    cfg = mlt.TrainConfig(
        num_worlds=args.num_worlds,
        num_agents_per_world=2,
        num_updates=args.num_updates,
        actions=actions,
        steps_per_update=16,
        num_bptt_chunks=2,
        lr=mlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=4,
        mesh=mesh_cfg,
        algo=mlt.PPOConfig(
            num_epochs=1, minibatch_size=8, clip_coef=0.2,
            value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
        pbt=mlt.PBTConfig(
            num_teams=2, team_size=1,
            num_train_policies=num_train, num_past_policies=num_past,
            self_play_portion=0.25, cross_play_portion=0.5,
            past_play_portion=0.25),
        dreamer_v3_critic=False,
        compute_dtype=dtype,
    )

    mgr = mlt.init_training(None, cfg, sim_fns, policy,
                            init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    mgr = shard_training_manager(mgr, mesh)

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)

    # Compile the Elo tournament on a background thread while the first
    # training updates run, so the first eval cycle doesn't stall on XLA.
    mlt.eval_elo_warmup(
        mgr, num_eval_steps=16,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))

    for i in range(args.num_updates):
        mgr = update(mgr)
        if (i + 1) % args.eval_interval == 0:
            mgr, deltas = mlt.eval_elo(
                mgr, num_eval_steps=16,
                eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
                train_sim_ctrl=jnp.zeros((1,), jnp.int32),
                # Rotate all-pairs coverage across cycles (underfilled
                # batches otherwise starve the same pairing tail).
                pair_offset=(i + 1) // args.eval_interval)
            mgr = mlt.update_population(mgr)
            elos = np.asarray(jax.device_get(
                mgr.state.policy_states.mmr.elo))
            if distributed.is_primary_host():
                print(f"update {i + 1}: elos="
                      f"{np.array2string(elos, precision=1)}", flush=True)
            if args.ckpt_dir:
                mgr.save_ckpt(args.ckpt_dir, block=False)  # async

    if args.ckpt_dir:
        mlt.wait_for_checkpoints()
    rewards = np.asarray(jax.device_get(
        mgr.metrics.metrics["Rewards"].mean))
    if distributed.is_primary_host():
        print(f"done; mean reward {np.nanmean(rewards):.4f}")


if __name__ == "__main__":
    main()
