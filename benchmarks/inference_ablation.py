"""Ablate the rollout inference step: sampling vs preprocess vs backbone.

collect_ablation.py showed the policy forward is ~93% of the rollout
loop at the headline shape. This breaks that forward down by timing
32-step scans of variants in one process:

- ``full``        : preprocess + rollout method (sampled actions + critic)
- ``argmax``      : same but sample_actions=False (no gumbel/PRNG path)
- ``nopre``       : rollout method on raw (cast-only) obs
- ``actor_only``  : preprocess + actor head only (no critic)
- ``critic_only`` : preprocess + critic head only (no actor/sampling)

Differences bound the cost of the sampling path, the EMA obs normalizer,
and each head. Run: python benchmarks/inference_ablation.py [--iters 5]
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

import jax

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

    backend = jax.default_backend()
    dtype = compute_dtype()
    mgr = bench.build_manager(dtype)
    steps = bench.STEPS_PER_UPDATE
    policy_states = mgr.state.policy_states
    obs = mgr.rollout.cur_obs
    rnn0 = mgr.rollout.rnn_states
    sync_leaf = lambda t: jax.device_get(jax.tree.leaves(t)[0])

    def preprocess(o):
        return policy_states.obs_preprocess.preprocess(
            policy_states.obs_preprocess_state, o, True)

    def apply(method, **kw):
        @jax.vmap
        def fn(state, *a):
            return state.apply_fn(
                {"params": state.params, "batch_stats": state.batch_stats},
                *a, train=False, method=method, **kw)
        return fn

    def scan_of(step_fn):
        # Args stay in sim layout ([N, ...]) and the chunk axis is added
        # INSIDE the jit: passing a pre-expanded [1, N, L, H] carry as a
        # jit parameter can force a slow layout on the carry; adding the
        # axis inside the jit lets XLA choose it.
        def run(rnn_states, obs, key):
            obs_c = jax.tree.map(lambda x: x[None], obs)
            rnn_c = jax.tree.map(lambda x: x[None], rnn_states)
            cast_obs_c = jax.tree.map(lambda x: x.astype(dtype), obs_c)
            def step(rnn, k):
                return step_fn(rnn, k, obs_c, cast_obs_c)
            _, ys = lax.scan(step, rnn_c, random.split(key, steps))
            return ys
        return jax.jit(run)

    variants = {}

    def full_step(rnn, k, obs_c, cast_obs_c):
        out, rnn = apply("rollout", sample_actions=True, return_debug=False)(
            policy_states, k[None], rnn, preprocess(obs_c))
        return rnn, out["actions"]["move"][0, 0, 0]

    variants["full"] = full_step

    def argmax_step(rnn, k, obs_c, cast_obs_c):
        out, rnn = apply("rollout", sample_actions=False, return_debug=False)(
            policy_states, k[None], rnn, preprocess(obs_c))
        return rnn, out["actions"]["move"][0, 0, 0]

    variants["argmax"] = argmax_step

    def nopre_step(rnn, k, obs_c, cast_obs_c):
        out, rnn = apply("rollout", sample_actions=True, return_debug=False)(
            policy_states, k[None], rnn, cast_obs_c)
        return rnn, out["actions"]["move"][0, 0, 0]

    variants["nopre"] = nopre_step

    def actor_step(rnn, k, obs_c, cast_obs_c):
        out, rnn = apply("actor_only")(
            policy_states, rnn, preprocess(obs_c))
        return rnn, out["actions"]["move"][0, 0, 0]

    variants["actor_only"] = actor_step

    def critic_step(rnn, k, obs_c, cast_obs_c):
        out, rnn = apply("critic_only")(
            policy_states, rnn, preprocess(obs_c))
        return rnn, out["critic"][0, 0, 0]

    variants["critic_only"] = critic_step

    results = {"backend": backend, "steps": steps,
               "num_worlds": bench.NUM_WORLDS}
    call_args = (rnn0, obs, random.PRNGKey(0))
    for name, step_fn in variants.items():
        try:
            c = scan_of(step_fn).lower(*call_args).compile()
            results[name + "_ms"] = round(time_compiled(
                c, call_args, sync_leaf, args.iters) * 1e3, 3)
        except Exception as e:  # record, keep the rest of the sweep
            results[name + "_error"] = repr(e)[:200]
        print(f"{name}: {results.get(name + '_ms', 'ERR')}", flush=True)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
