"""Profile the PBT/complex-matchmaking update step (BASELINE config #4).

This harness applies the profile_update.py methodology at the config-#4 shape
(8 train + 4 past policies, 16384 worlds x 2 agents, 25/50/25
self/cross/past play):

1. donated chained steady-state timing (the production configuration),
2. an XProf trace of one steady-state update (artifacts/xprof_pbt/),
3. the optimized HLO text alongside it, so scripts/xprof_summary.py
   --hlo can join device self-time onto the named-scope cost centers
   (Gather Chunk Weights / Reorder To Policy / Policy Apply / Sim Step /
   Matchmaking / Compute Reorder State / store emission / Learn ...).

Run:     python benchmarks/profile_pbt.py
Analyze: python scripts/xprof_summary.py artifacts/xprof_pbt \
             --hlo artifacts/xprof_pbt/hlo.txt
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import jax

import jax.numpy as jnp

from madrona_learn_tpu.utils.platform import compute_dtype

try:
    from _timing import time_compiled_chain
except ImportError:
    from benchmarks._timing import time_compiled_chain


NUM_TRAIN, NUM_PAST = 8, 4
NUM_WORLDS = 16384
STEPS = 32
CH = 256


def build_manager(dtype, num_worlds=NUM_WORLDS, steps=STEPS,
                  chunk_override=0, num_train=NUM_TRAIN, num_past=NUM_PAST,
                  portions=(0.25, 0.5, 0.25)):
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env
    from madrona_learn_tpu.models import (
        ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, LSTM, MLP,
        RecurrentBackboneEncoder)

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_duel_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=32, num_teams=2, team_size=1,
        seed=0, reward_dtype=jnp.float32))

    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["time"], obs["acc"]], -1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=CH, num_layers=2, dtype=dtype),
                rnn=LSTM(num_hidden_channels=CH, num_layers=1,
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

    # train agents/policy: sim_batch * (self + cross/2 + past/2) / P
    # (= 2560 at the default 8-train 16384-world shape); seqs = 2x that,
    # split into 4 minibatches (matches pbt_bench.py at default shape).
    sp, cp, pp = portions
    train_agents = int(num_worlds * 2 * (sp + cp / 2 + pp / 2)) // num_train
    minibatch_size = max(train_agents * 2 // 4, 1)
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=2, num_updates=10,
        actions=actions, steps_per_update=steps, num_bptt_chunks=2,
        lr=1e-3, gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1, minibatch_size=minibatch_size, clip_coef=0.2,
            value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
        pbt=mlt.PBTConfig(
            num_teams=2, team_size=1,
            num_train_policies=num_train, num_past_policies=num_past,
            self_play_portion=sp, cross_play_portion=cp,
            past_play_portion=pp,
            rollout_policy_chunk_size_override=chunk_override),
        dreamer_v3_critic=False, compute_dtype=dtype)
    return mlt.init_training(
        None, cfg, sim_fns, policy,
        init_sim_ctrl=jnp.zeros((1,), jnp.int32))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-trace", action="store_true")
    parser.add_argument("--updates", type=int, default=5)
    parser.add_argument("--worlds", type=int, default=NUM_WORLDS)
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--out-dir", default="artifacts/xprof_pbt")
    parser.add_argument("--chunk-override", type=int, default=0,
                        help="rollout_policy_chunk_size_override")
    parser.add_argument("--chunk-sweep", type=str, default=None,
                        help="comma-separated chunk sizes: time each "
                             "end-to-end in ONE process (no trace)")
    parser.add_argument("--train-policies", type=int, default=NUM_TRAIN)
    parser.add_argument("--past-policies", type=int, default=NUM_PAST)
    parser.add_argument("--portions", type=str, default="0.25,0.5,0.25",
                        help="self,cross,past play portions")
    args = parser.parse_args()

    backend = jax.default_backend()
    dtype = compute_dtype()

    if args.chunk_sweep:
        agent_steps = args.worlds * 2 * args.steps
        portions = tuple(float(x) for x in args.portions.split(","))
        for c in (int(x) for x in args.chunk_sweep.split(",")):
            mgr = build_manager(dtype, args.worlds, args.steps, c,
                                args.train_policies, args.past_policies,
                                portions)
            update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
            update_c = update.lower(mgr).compile()
            sync = lambda m: jax.device_get(m.metrics.metrics["Loss"].mean)
            full_dt, _ = time_compiled_chain(
                update_c, mgr, sync, n=args.updates)
            print(json.dumps({
                "chunk": c,
                "num_chunks": mgr.rollout.cfg.num_policy_chunks,
                "update_ms": round(full_dt * 1e3, 2),
                "agent_steps_per_s": round(agent_steps / full_dt, 1),
            }), flush=True)
        return

    t0 = time.perf_counter()
    mgr = build_manager(dtype, args.worlds, args.steps, args.chunk_override,
                        args.train_policies, args.past_policies,
                        tuple(float(x) for x in args.portions.split(",")))
    print(f"init {time.perf_counter() - t0:.0f}s", file=sys.stderr)

    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    t0 = time.perf_counter()
    update_c = update.lower(mgr).compile()
    print(f"compile {time.perf_counter() - t0:.0f}s", file=sys.stderr)

    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hlo.txt"), "w") as f:
        f.write(update_c.as_text())

    sync_loss = lambda m: jax.device_get(m.metrics.metrics["Loss"].mean)
    full_dt, live_mgr = time_compiled_chain(
        update_c, mgr, sync_loss, n=args.updates)

    agent_steps = args.worlds * 2 * args.steps
    result = {
        "backend": backend,
        "config": "BASELINE #4 (PBT 8+4, 25/50/25 play)",
        "agents": args.worlds * 2,
        "update_ms": round(full_dt * 1e3, 2),
        "agent_steps_per_s": round(agent_steps / full_dt, 1),
        "trace_dir": None,
    }

    if not args.no_trace:
        m = update_c(live_mgr)
        sync_loss(m)
        with jax.profiler.trace(out_dir):
            m = update_c(m)
            sync_loss(m)
        result["trace_dir"] = out_dir

    print(json.dumps(result))


if __name__ == "__main__":
    main()
