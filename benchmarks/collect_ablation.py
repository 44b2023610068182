"""Ablate the collect phase: where do the rollout milliseconds go?

Collect is a fused scan of many small parts.
This harness times jitted sub-programs that isolate each:

- ``collect``        : the full RolloutManager.collect (store + obs-stats +
                       bootstrap + GAE/finalize included)
- ``loop``           : rollout_loop alone with no-op callbacks (inference +
                       sim step + glue; no store, no obs-stats, no finalize)
- ``inference``      : a scan of just the policy forward (obs preprocess +
                       MLP/LSTM/heads + action sampling) on fixed obs
- ``sim``            : a scan of just the sim step_fn with constant actions

Derived: store/finalize overhead = collect - loop; per-step glue
(reorder, resets, env returns, PRNG, emit plumbing) = loop - inference -
sim. All timings device_get-synced, averaged over --iters timed calls
after one warmup.

Run: python benchmarks/collect_ablation.py [--iters 5]
"""

import argparse
import json
import sys
from functools import partial

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from madrona_learn_tpu.utils.platform import compute_dtype
from jax import lax, random

try:
    from _timing import time_compiled  # script-style run
except ImportError:  # runpy from the repo root (campaign runner)
    from benchmarks._timing import time_compiled


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()

    import bench
    from madrona_learn_tpu.struct import FrozenDict
    from madrona_learn_tpu.ops.metrics import TrainingMetrics
    from madrona_learn_tpu.rollouts import RolloutManager, rollout_loop

    backend = jax.default_backend()
    dtype = compute_dtype()
    mgr = bench.build_manager(dtype)
    steps = bench.STEPS_PER_UPDATE
    policy_states = mgr.state.policy_states
    rollout_mgr = RolloutManager(mgr.cfg, mgr.rollout, policy_states)
    sync_leaf = lambda t: jax.device_get(jax.tree.leaves(t)[0])

    results = {"backend": backend, "steps": steps,
               "num_worlds": bench.NUM_WORLDS}

    # -- full collect --------------------------------------------------------
    def collect_full(state, rollout):
        metrics = TrainingMetrics.create(
            rollout_mgr.add_metrics(mgr.cfg, FrozenDict({})),
            buffer_size=1, start_update_idx=0, num_policies=1)
        out = rollout_mgr.collect(
            state, rollout, metrics,
            lambda rs, us: (rs, us),
            lambda r, bv, uv, ubv, us: (r, us),
            lambda m, r, us: m)
        return out[2].data

    c = jax.jit(collect_full).lower(mgr.state, mgr.rollout).compile()
    results["collect_ms"] = time_compiled(
        c, (mgr.state, mgr.rollout),
        lambda d: jax.device_get(jax.tree.leaves(d)[0][0, 0]),
        args.iters) * 1e3

    # -- rollout_loop with no-op callbacks -----------------------------------
    def noop_inference(step_idx, obs, pre_obs, policy_out, reorder, cb):
        return cb, None

    def noop_step(step_idx, rollout_state, dones, rewards, episodes, cb):
        return rollout_state, cb, None

    def loop_only(rollout):
        rollout, _, _ = rollout_loop(
            rollout, policy_states, steps, noop_inference, noop_step, None,
            sample_actions=True, return_debug=False)
        return rollout.env_returns

    c = jax.jit(loop_only).lower(mgr.rollout).compile()
    results["loop_ms"] = time_compiled(
        c, (mgr.rollout,), sync_leaf, args.iters) * 1e3

    # -- inference-only scan -------------------------------------------------
    obs = mgr.rollout.cur_obs
    rnn0 = mgr.rollout.rnn_states

    def inference_only(rnn_states, obs, key):
        # Mirror rollout_loop's chunked structure at num_chunks=1: stacked
        # (P=1) policy states, obs/rnn with a leading chunk axis.
        obs_c = jax.tree.map(lambda x: x[None], obs)
        rnn_c = jax.tree.map(lambda x: x[None], rnn_states)

        @jax.vmap
        def policy_fn(state, sample_key, rnn, pre):
            return state.apply_fn(
                {"params": state.params, "batch_stats": state.batch_stats},
                sample_key, rnn, pre, train=False, sample_actions=True,
                return_debug=False, method="rollout")

        def step(carry, step_key):
            rnn = carry
            pre = policy_states.obs_preprocess.preprocess(
                policy_states.obs_preprocess_state, obs_c, True)
            out, rnn = policy_fn(
                policy_states, step_key[None], rnn, pre)
            return rnn, out["actions"]["move"][0, 0, 0]

        rnn, acts = lax.scan(step, rnn_c, random.split(key, steps))
        return acts

    c = jax.jit(inference_only).lower(
        rnn0, obs, random.PRNGKey(0)).compile()
    results["inference_ms"] = time_compiled(
        c, (rnn0, obs, random.PRNGKey(0)), sync_leaf, args.iters) * 1e3

    # -- sim-step-only scan --------------------------------------------------
    from madrona_learn_tpu.struct import freeze

    step_fn = mgr.rollout.step_fn
    zero_actions = {
        "move": jnp.zeros((mgr.cfg.num_worlds, 1), jnp.int32)}
    resets = jnp.zeros((mgr.cfg.num_worlds, 1), jnp.int32)
    sim_ctrl = mgr.rollout.sim_ctrl
    assignments = jnp.zeros((mgr.cfg.num_worlds, 1), jnp.int32)

    def sim_only(sim_state):
        def step(state, _):
            out = freeze(step_fn(freeze({
                "state": state, "actions": zero_actions,
                "resets": resets, "sim_ctrl": sim_ctrl,
                "pbt": FrozenDict(
                    {"policy_assignments": assignments}),
            })))
            return out["state"], out["rewards"][0]

        state, r = lax.scan(step, sim_state, None, length=steps)
        return r

    c = jax.jit(sim_only).lower(mgr.rollout.sim_state).compile()
    results["sim_ms"] = time_compiled(
        c, (mgr.rollout.sim_state,), sync_leaf, args.iters) * 1e3

    results["store_finalize_ms"] = round(
        results["collect_ms"] - results["loop_ms"], 3)
    results["glue_ms"] = round(
        results["loop_ms"] - results["inference_ms"] - results["sim_ms"], 3)
    for k in ("collect_ms", "loop_ms", "inference_ms", "sim_ms"):
        results[k] = round(results[k], 3)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
