"""Multi-policy rollout-inference throughput (ac_test methodology).

Mirrors the reference's throughput micro-benchmark (reference:
tests/ac_test.py:322-369): a population of LSTM policies serving a large
agent batch with per-step random policy assignment, argsort-based policy
chunk batching, AOT-compiled N-step loop, printed agent-steps/s.

This stresses the complex-matchmaking path: per-step
``compute_reorder_chunks`` + chunked gather + vmapped apply over the
population.

Run: python benchmarks/infer_bench.py [--policies 32] [--agents 16384]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from madrona_learn_tpu.utils.platform import compute_dtype
from madrona_learn_tpu.struct import FrozenDict
from jax import lax, random


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--policies", type=int, default=32)
    parser.add_argument("--agents", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--channels", type=int, default=512)
    parser.add_argument(
        "--chunk", type=str, default="",
        help="comma-separated policy chunk sizes to sweep (default: the "
             "N//P heuristic)")
    args = parser.parse_args()

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
    from madrona_learn_tpu.ops.reorder import (
        PolicyBatchReorderState,
        compute_reorder_chunks,
    )

    backend = jax.default_backend()
    dtype = compute_dtype()

    P = args.policies
    N = args.agents
    from madrona_learn_tpu.rollouts import heuristic_policy_chunk_size

    # The production heuristic, so the bench measures the shipped geometry.
    default_c = heuristic_policy_chunk_size(N, P, N // P)
    chunk_sizes = ([int(c) for c in args.chunk.split(",")] if args.chunk
                   else [default_c])

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: obs["feat"],
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=args.channels, num_layers=2,
                        dtype=dtype),
                rnn=LSTM(num_hidden_channels=args.channels, num_layers=1,
                         dtype=dtype),
            ),
        ),
        actor=DictActor(heads={
            "move": DenseLayerDiscreteActor(cfg=actions["move"], dtype=dtype),
        }),
        critic=DenseLayerCritic(dtype=dtype),
    )

    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        obs = FrozenDict({"feat": jnp.zeros((N, 64), dtype)})
        rnn_states = actor_critic.init_recurrent_state(N)

        def init_one(rnd):
            rnn1 = actor_critic.init_recurrent_state(1)
            obs1 = jax.tree.map(lambda x: x[0:1], obs)
            return actor_critic.init(
                rnd, random.PRNGKey(0), rnn1, obs1, method="rollout")

        params = jax.jit(jax.vmap(init_one))(random.split(random.key(0), P))

    dev = jax.devices()[0]
    params, obs, rnn_states = jax.device_put((params, obs, rnn_states), dev)

    @jax.vmap
    def apply_chunk(params, key, rnn, obs):
        return actor_critic.apply(
            params, key, rnn, obs, method="rollout")

    for C in chunk_sizes:
      B = -(N // -C) + P - 1

      def run(params, obs, rnn_states, key):
        def step(carry, _):
            rnn_states, key = carry
            key, assign_key, sample_key = random.split(key, 3)
            assignments = random.randint(assign_key, (N,), 0, P)

            to_policy, to_sim = compute_reorder_chunks(assignments, P, C, B)
            reorder = PolicyBatchReorderState(
                to_policy_idxs=to_policy, to_sim_idxs=to_sim,
                policy_dims=(P, C), sim_dims=(N,))

            chunk_params = jax.tree.map(
                lambda x: x[reorder.to_policy(assignments)[:, 0]], params)
            chunk_rnn, chunk_obs = reorder.to_policy((rnn_states, obs))

            out, new_rnn = apply_chunk(
                chunk_params, random.split(sample_key, B), chunk_rnn,
                chunk_obs)

            rnn_states = reorder.to_sim(new_rnn)
            actions = reorder.to_sim(out["actions"]["move"])
            return (rnn_states, key), actions[0, 0]

        (rnn_states, key), _ = lax.scan(
            step, (rnn_states, key), None, length=args.steps)
        return rnn_states

      def run_reduced(params, obs, rnn_states, key):
        out = run(params, obs, rnn_states, key)
        # Reduce to scalars, which the timing loop fetches to sync.
        return jax.tree.map(
            lambda x: jnp.sum(x.astype(jnp.float32)), out)

      compiled = jax.jit(run_reduced).lower(
          params, obs, rnn_states, random.key(1)).compile()

      jax.device_get(compiled(params, obs, rnn_states, random.key(1)))

      start = time.perf_counter()
      jax.device_get(compiled(params, obs, rnn_states, random.key(2)))
      elapsed = time.perf_counter() - start

      rate = N * args.steps / elapsed
      print(f"{P} policies x {N} agents x {args.steps} steps "
            f"({args.channels}ch {dtype.__name__}, chunk {C} x {B}): "
            f"{rate:,.0f} agent-steps/s on {backend}")


if __name__ == "__main__":
    main()
