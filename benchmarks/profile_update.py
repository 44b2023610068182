"""Profile the headline bench update step: MFU + phase breakdown + XProf.

Answers "where does the update-step time go" with three measurements:

1. **MFU**: model FLOPs per update over measured wall time vs. the
   device's published peak bf16 rate (``PEAK_BF16_FLOPS``, keyed by
   ``device_kind``; a device missing from the table is an error).
2. **Phase split** (an estimate): the rollout-collection sub-program
   (inference + sim + GAE + store finalize) is compiled and timed
   standalone; learn time is the difference to the full update. A
   standalone program sees other layouts and pays its own dispatch, so
   use the trace attribution (scripts/xprof_summary.py over the trace
   artifact) for per-phase numbers.
3. **XProf artifact**: a ``jax.profiler.trace`` capture of the steady-state
   update, written to ``artifacts/xprof/`` for TensorBoard's profile plugin.

``--donate`` compiles the update with ``donate_argnums=0`` (the production
training-loop configuration) and times it as a chained ``m = update(m)``
loop; the phase split is skipped there (the collect sub-program cannot
share donated buffers).

Run: python benchmarks/profile_update.py [--no-trace] [--donate]
"""

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

# Dense bf16 tensor-core peak by jax device_kind (NVIDIA H100 data sheet,
# SXM part, without sparsity; at the 700 W power limit).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


try:
    from _timing import time_compiled, time_compiled_chain  # script run
except ImportError:  # runpy from the repo root (campaign runner)
    from benchmarks._timing import time_compiled, time_compiled_chain


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-trace", action="store_true")
    parser.add_argument("--donate", action="store_true",
                        help="donate the manager buffers (production loop "
                             "configuration); skips the phase split")
    parser.add_argument("--updates", type=int, default=5)
    args = parser.parse_args()

    import bench
    from madrona_learn_tpu.struct import FrozenDict

    from madrona_learn_tpu.ops.metrics import TrainingMetrics
    from madrona_learn_tpu.rollouts import RolloutManager

    from madrona_learn_tpu.utils.platform import compute_dtype

    device = bench.device_record()
    peak = PEAK_BF16_FLOPS.get(device["kind"])
    if peak is None:
        raise SystemExit(f"no peak rate on record for {device['kind']!r}")
    mgr = bench.build_manager(compute_dtype())

    sync = lambda m: jax.device_get(jax.tree.leaves(m)[0])

    # -- analytic model FLOPs ------------------------------------------------
    # XLA's whole-program cost_analysis counts while-loop bodies ONCE, so
    # it wildly underestimates scan-heavy RL programs. Instead, measure
    # loop-free single-step programs and scale by token counts.
    from madrona_learn_tpu.struct import FrozenDict as FD
    from jax import random as jrandom

    actor_critic, _ = bench.build_actor_critic(dtype)
    probe = 1024
    obs = FD({"delta": jnp.zeros((probe, 2), dtype),
              "time": jnp.zeros((probe, 1), dtype)})
    rnn = actor_critic.init_recurrent_state(probe)
    variables = jax.jit(partial(actor_critic.init, method="rollout"))(
        jrandom.PRNGKey(0), jrandom.PRNGKey(1), rnn, obs)

    def rollout_step(v, key, rnn, obs):
        return actor_critic.apply(v, key, rnn, obs, method="rollout")

    fwd_flops = jax.jit(rollout_step).lower(
        variables, jrandom.PRNGKey(2), rnn, obs).compile(
        ).cost_analysis().get("flops", 0.0) / probe

    def train_step(v, rnn, dones, actions, obs_seq):
        def loss(v):
            out = actor_critic.apply(
                v, rnn, dones, actions, obs_seq, train=False,
                method="update")
            total = sum(jnp.sum(l.astype(jnp.float32))
                        for l in jax.tree.leaves(out))
            return total
        return jax.grad(loss)(v)

    obs1 = jax.tree.map(lambda x: x[None], obs)     # [T=1, N, ...]
    dones1 = jnp.zeros((1, probe, 1), jnp.bool_)
    actions1 = {"move": jnp.zeros((1, probe, 1), jnp.int32)}
    bwd_flops = jax.jit(train_step).lower(
        variables, rnn, dones1, actions1, obs1).compile(
        ).cost_analysis().get("flops", 0.0) / probe

    tokens = bench.NUM_WORLDS * bench.STEPS_PER_UPDATE
    num_epochs = 1
    flops = tokens * (fwd_flops + num_epochs * bwd_flops)

    # -- full update ---------------------------------------------------------
    sync_loss = lambda m: jax.device_get(m.metrics.metrics["Loss"].mean)
    if args.donate:
        update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
        update_c = update.lower(mgr).compile()
        full_dt, live_mgr = time_compiled_chain(
            update_c, mgr, sync_loss, n=args.updates)
    else:
        update = jax.jit(lambda m: m.update_iter())
        update_c = update.lower(mgr).compile()
        full_dt = time_compiled(update_c, (mgr,), sync_loss, n=args.updates)
        live_mgr = mgr

    env_steps = bench.NUM_WORLDS * bench.STEPS_PER_UPDATE
    steps_per_s = env_steps / full_dt
    mfu = flops / full_dt / peak

    # -- collect-only sub-program (phase split; UNSTABLE — see docstring) ----
    collect_dt = learn_dt = None
    if not args.donate:
        policy_states = mgr.state.policy_states
        rollout_mgr = RolloutManager(mgr.cfg, mgr.rollout, policy_states)

        def collect_only(state, rollout):
            metrics = TrainingMetrics.create(
                rollout_mgr.add_metrics(mgr.cfg, FrozenDict({})),
                buffer_size=1, start_update_idx=0, num_policies=1)
            out = rollout_mgr.collect(
                state, rollout, metrics,
                lambda rs, us: (rs, us),
                lambda r, bv, uv, ubv, us: (r, us),
                lambda m, r, us: m)
            return out[2]  # rollout_data

        collect_c = jax.jit(collect_only).lower(
            mgr.state, mgr.rollout).compile()
        collect_dt = time_compiled(
            collect_c, (mgr.state, mgr.rollout),
            lambda rd: jax.device_get(
                jax.tree.leaves(rd.data)[0][0, 0]),
            n=args.updates)

        learn_dt = max(full_dt - collect_dt, 0.0)

    # -- XProf capture -------------------------------------------------------
    trace_dir = None
    if not args.no_trace:
        trace_dir = os.path.abspath("artifacts/xprof")
        os.makedirs(trace_dir, exist_ok=True)
        m = update_c(live_mgr)
        sync_loss(m)
        with jax.profiler.trace(trace_dir):
            m = update_c(m)
            sync_loss(m)

    result = {
        "device": device,
        "donate": args.donate,
        "env_steps_per_s": round(steps_per_s, 1),
        "update_ms": round(full_dt * 1e3, 2),
        "model_flops_per_update": flops,
        "fwd_flops_per_token": round(fwd_flops, 1),
        "train_fwd_bwd_flops_per_token": round(bwd_flops, 1),
        "mfu": round(mfu, 4),
        "trace_dir": trace_dir,
    }
    if collect_dt is not None:
        result.update({
            # Subtraction-based estimate only; use
            # scripts/xprof_summary.py for per-phase attribution.
            "collect_ms_estimate": round(collect_dt * 1e3, 2),
            "learn_ms_estimate": round(learn_dt * 1e3, 2),
        })
    print(json.dumps(result))


if __name__ == "__main__":
    main()
