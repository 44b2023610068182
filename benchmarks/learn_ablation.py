"""Ablate the learn phase with DIRECT sub-program timings.

The collect/learn split by standalone-collect subtraction is noisy across
processes; this harness instead compiles the
learn phase itself (the vmapped PPO optimize on a frozen RolloutData) and
its inner pieces, all in one process:

- ``update``   : the full resident update step (reference point)
- ``collect``  : RolloutManager.collect standalone
- ``learn``    : vmap(algo.update) on a frozen RolloutData — the real
                 learn phase, measured directly rather than by subtraction
- ``mb_fwd``   : one minibatch forward (apply method='update')
- ``mb_fwdbwd``: same with jax.grad through a scalarized loss — the
                 fwd+bwd cost per minibatch (x num_minibatches for the
                 per-update total; the remainder of ``learn`` is optimizer
                 + weight projection + z-scores + minibatch gathers)

Standalone sub-program timing can overstate: large jit *parameters*
receive default layouts (and standalone outputs must materialize to
device memory), where the full update lets XLA choose layouts for the
same tensors as internal values. Use this harness for RELATIVE regressions of one
sub-program over time, never for cross-program attribution; in-context
attribution needs the XProf trace (benchmarks/profile_update.py).

Run: python benchmarks/learn_ablation.py [--iters 5]
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from madrona_learn_tpu.utils.platform import compute_dtype

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
    from madrona_learn_tpu.rollouts import RolloutManager

    backend = jax.default_backend()
    dtype = compute_dtype()
    mgr = bench.build_manager(dtype)
    algo = mgr.cfg.algo.setup()
    sync_leaf = lambda t: jax.device_get(jax.tree.leaves(t)[0])
    results = {"backend": backend, "num_worlds": bench.NUM_WORLDS,
               "minibatch_size": mgr.cfg.algo.minibatch_size,
               "num_epochs": mgr.cfg.algo.num_epochs}

    # -- full update ----------------------------------------------------------
    update_c = jax.jit(lambda m: m.update_iter()).lower(mgr).compile()
    results["update_ms"] = time_compiled(
        update_c, (mgr,),
        lambda m: jax.device_get(m.metrics.metrics["Loss"].mean),
        args.iters) * 1e3

    # -- collect (standalone) -------------------------------------------------
    rollout_mgr = RolloutManager(mgr.cfg, mgr.rollout,
                                 mgr.state.policy_states)

    def collect_only(state, rollout):
        metrics = TrainingMetrics.create(
            rollout_mgr.add_metrics(mgr.cfg, FrozenDict({})),
            buffer_size=1, start_update_idx=0, num_policies=1)
        out = rollout_mgr.collect(
            state, rollout, metrics,
            lambda rs, us: (rs, us),
            lambda r, bv, uv, ubv, us: (r, us),
            lambda m, r, us: m)
        return out[2]

    collect_c = jax.jit(collect_only).lower(mgr.state, mgr.rollout).compile()
    results["collect_ms"] = time_compiled(
        collect_c, (mgr.state, mgr.rollout),
        lambda rd: jax.device_get(jax.tree.leaves(rd.data)[0][0, 0]),
        args.iters) * 1e3

    # Freeze one batch of rollout data for the learn-side timings.
    rollout_data = collect_c(mgr.state, mgr.rollout)
    metrics0 = TrainingMetrics.create(
        algo.add_metrics(mgr.cfg, FrozenDict({})),
        buffer_size=1, start_update_idx=0, num_policies=1)

    # -- learn (direct) -------------------------------------------------------
    def learn_only(policy_states, train_states, rollout_data, metrics):
        @jax.vmap
        def algo_wrapper(policy_state, train_state, rd, m):
            return algo.update(
                mgr.cfg, policy_state, train_state, rd,
                lambda metrics, epoch, mb, ps, ts: metrics, m)
        return algo_wrapper(policy_states, train_states, rollout_data,
                            metrics)

    learn_args = (mgr.state.policy_states, mgr.state.train_states,
                  rollout_data, metrics0)
    learn_c = jax.jit(learn_only).lower(*learn_args).compile()
    results["learn_ms"] = time_compiled(
        learn_c, learn_args,
        lambda out: jax.device_get(out[2].metrics["Loss"].mean),
        args.iters) * 1e3

    # -- one minibatch fwd / fwd+bwd ------------------------------------------
    pstate = jax.tree.map(lambda x: x[0], mgr.state.policy_states)
    rd0 = jax.tree.map(lambda x: x[0], rollout_data.data)
    mb_size = mgr.cfg.algo.minibatch_size
    rd0 = rollout_data.replace(data=rd0)
    mb = rd0.minibatch(jnp.arange(mb_size))

    def mb_forward(params, mb):
        out = pstate.apply_fn(
            {"params": params, "batch_stats": pstate.batch_stats},
            mb["rnn_start_states"],
            mb["dones"],
            mb["actions"],
            mb["obs"],
            train=True,
            method="update",
        )
        return out

    def mb_loss(params, mb):
        out = mb_forward(params, mb)
        return sum(jnp.sum(l.astype(jnp.float32))
                   for l in jax.tree.leaves(out))

    fwd_c = jax.jit(mb_forward).lower(pstate.params, mb).compile()
    results["mb_fwd_ms"] = time_compiled(
        fwd_c, (pstate.params, mb), sync_leaf, args.iters) * 1e3

    bwd_c = jax.jit(jax.grad(mb_loss)).lower(pstate.params, mb).compile()
    results["mb_fwdbwd_ms"] = time_compiled(
        bwd_c, (pstate.params, mb), sync_leaf, args.iters) * 1e3

    num_minibatches = (rollout_data.num_train_seqs_per_policy
                       // mb_size) * mgr.cfg.algo.num_epochs
    results["num_minibatches"] = num_minibatches
    results["learn_minus_fwdbwd_ms"] = round(
        results["learn_ms"] - num_minibatches * results["mb_fwdbwd_ms"], 3)
    for k in ("update_ms", "collect_ms", "learn_ms", "mb_fwd_ms",
              "mb_fwdbwd_ms"):
        results[k] = round(results[k], 3)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
