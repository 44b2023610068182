"""PBT self-play training on the competitive duel env: population of
policies with hyperparameter exploration, periodic Elo tournaments, and
cull/past population evolution.

Run: python examples/train_pbt.py [--num-updates N]
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

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
from madrona_learn_tpu.utils.platform import use_checkout_compile_cache


def get_episode_scores(episode_result):
    winner = episode_result[0]
    a = jnp.where(winner == 0, 1.0, jnp.where(winner == 1, 0.0, 0.5))
    return a, 1.0 - a


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-updates", type=int, default=40)
    parser.add_argument("--num-worlds", type=int, default=256)
    parser.add_argument("--eval-interval", type=int, default=10)
    args = parser.parse_args()

    use_checkout_compile_cache()
    dtype = jnp.float32
    num_train, num_past = 4, 2
    episode_len = 16

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_duel_env(ToyEnvConfig(
        num_worlds=args.num_worlds, episode_len=episode_len,
        num_teams=2, team_size=1))

    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["time"], obs["acc"]], axis=-1),
            encoder=BackboneEncoder(
                net=MLP(num_channels=64, num_layers=2, dtype=dtype)),
        ),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype),
        }),
        critic=DenseLayerCritic(dtype=dtype),
    )
    policy = mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
        get_episode_scores=get_episode_scores,
    )

    cfg = mlt.TrainConfig(
        num_worlds=args.num_worlds,
        num_agents_per_world=2,
        num_updates=args.num_updates,
        actions=actions,
        steps_per_update=32,
        num_bptt_chunks=2,
        lr=mlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=10,
        algo=mlt.PPOConfig(
            num_epochs=1,
            # sequences/policy = num_bptt_chunks * train-agents/policy;
            # train agents = self + cross/2 + past/2 of the sim batch.
            minibatch_size=(2 * int(args.num_worlds * 2 * 0.625)
                            // num_train) // 2,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        pbt=mlt.PBTConfig(
            num_teams=2,
            team_size=1,
            num_train_policies=num_train,
            num_past_policies=num_past,
            self_play_portion=0.25,
            cross_play_portion=0.5,
            past_play_portion=0.25,
        ),
        dreamer_v3_critic=False,
        compute_advantages=True,
    )

    mgr = mlt.init_training(
        None, cfg, sim_fns, policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    eval_kwargs = dict(
        num_eval_steps=4 * episode_len,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))
    # eval_elo jits + caches the tournament internally; warm its compile
    # on a background thread while the first updates run.
    mlt.eval_elo_warmup(mgr, **eval_kwargs)
    # pair_offset sweeps all-pairs coverage across cycles when the batch
    # underfills the pairing list (traced arg: no recompilation).
    run_eval = lambda m, cycle: mlt.eval_elo(
        m, pair_offset=cycle, **eval_kwargs)
    evolve = jax.jit(mlt.update_population)

    for i in range(args.num_updates):
        mgr = update(mgr)
        if (i + 1) % args.eval_interval == 0:
            mgr, deltas = run_eval(mgr, (i + 1) // args.eval_interval)
            mgr = evolve(mgr)
            elos = np.asarray(mgr.state.policy_states.mmr.elo)
            lrs = np.asarray(mgr.state.train_states.hyper_params.lr)
            print(f"update {i + 1}: elos={np.round(elos, 1)} "
                  f"lrs={np.format_float_scientific(lrs[0], 2)}..."
                  )

    print("done")


if __name__ == "__main__":
    main()
