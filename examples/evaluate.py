"""Offline policy evaluation from a training checkpoint.

Trains a short toy run if no checkpoint is given, then loads the policies
back with ``eval_load_ckpt`` and rolls them out with ``eval_policies``,
streaming per-step data to a callback that accumulates episode returns.

Run:
    python examples/evaluate.py [--ckpt ckpts/50] [--num-worlds 256]
        [--eval-steps 200] [--policy N]
"""

import argparse
import os
import tempfile

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


def build_policy(actions, dtype):
    return mlt.Policy(
        actor_critic=ActorCritic(
            backbone=BackboneShared(
                prefix=lambda obs, train: jnp.concatenate(
                    [obs["delta"], obs["time"]], axis=-1),
                encoder=RecurrentBackboneEncoder(
                    net=MLP(num_channels=256, num_layers=2, dtype=dtype),
                    rnn=LSTM(num_hidden_channels=256, num_layers=1,
                             dtype=dtype))),
            actor=DictActor(heads={"move": DenseLayerDiscreteActor(
                cfg=actions["move"], dtype=dtype)}),
            critic=DreamerV3Critic(dtype=dtype)),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))


def quick_train(actions, policy, num_worlds, dtype, ckpt_dir):
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8))
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=1, num_updates=30,
        actions=actions, steps_per_update=40, num_bptt_chunks=2, lr=1e-3,
        gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=10,
        algo=mlt.PPOConfig(
            num_epochs=2, minibatch_size=num_worlds, clip_coef=0.2,
            value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=True, compute_dtype=dtype)
    mgr = mlt.init_training(None, cfg, sim_fns, policy,
                            init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    for _ in range(cfg.num_updates):
        mgr = update(mgr)
    mgr.save_ckpt(ckpt_dir)
    return os.path.join(ckpt_dir, str(int(mgr.update_idx)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--num-worlds", type=int, default=256)
    parser.add_argument("--eval-steps", type=int, default=200)
    parser.add_argument("--policy", type=int, default=None,
                        help="evaluate a single policy index")
    args = parser.parse_args()

    use_checkout_compile_cache()
    dtype = compute_dtype()
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    policy = build_policy(actions, dtype)

    ckpt = args.ckpt
    if ckpt is None:
        ckpt_dir = tempfile.mkdtemp(prefix="eval_example_")
        print(f"no --ckpt given; training 30 quick updates -> {ckpt_dir}")
        ckpt = quick_train(actions, policy, args.num_worlds, dtype, ckpt_dir)

    policy_states, num_policies = mlt.eval_load_ckpt(
        policy, ckpt, single_policy=args.policy)
    print(f"loaded {num_policies} policies from {ckpt}")

    eval_cfg = mlt.EvalConfig(
        num_worlds=args.num_worlds,
        num_teams=1,
        team_size=1,
        num_eval_steps=args.eval_steps,
        actions=actions,
        reward_gamma=0.99,
        policy_dtype=dtype,
        eval_competitive=False,
        use_deterministic_policy=True,
    )

    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=args.num_worlds, episode_len=40, grid_size=8, seed=17))

    totals = {"reward_sum": 0.0, "episodes": 0, "return_sum": 0.0}

    def host_accumulate(rewards, dones, returns):
        rewards = np.asarray(rewards, np.float32)
        dones = np.asarray(dones, bool).reshape(-1)
        returns = np.asarray(returns, np.float32).reshape(-1)
        totals["reward_sum"] += float(rewards.sum())
        totals["episodes"] += int(dones.sum())
        totals["return_sum"] += float(returns[dones].sum())
        return np.int32(0)

    def step_cb(step_data):
        # step_cb runs inside the jitted eval loop; stream per-step data to
        # the host with an ordered io_callback.
        from jax.experimental import io_callback

        io_callback(
            host_accumulate, jax.ShapeDtypeStruct((), jnp.int32),
            step_data["rewards"], step_data["dones"],
            step_data["returns"], ordered=True)
        return step_data["sim_state"]

    mlt.eval_policies(
        None, eval_cfg, sim_fns, policy,
        jnp.zeros((1,), jnp.int32), policy_states, step_cb)

    steps = args.eval_steps * args.num_worlds
    print(f"eval: {steps} agent-steps, "
          f"mean step reward {totals['reward_sum'] / steps:.4f}, "
          f"{totals['episodes']} episodes"
          + (f", mean episode return "
             f"{totals['return_sum'] / totals['episodes']:.3f}"
             if totals["episodes"] else ""))


if __name__ == "__main__":
    main()
