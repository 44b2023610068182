"""Start-up proof on the GPU: the training main path runs and is right.

Phases, all in this one process (only ``nvidia-smi`` runs as a child):

1. device: JAX must run on a GPU; prints the device and ``nvidia-smi``'s
   name and power limit.
2. reference: each plain hot path at a real width against a float32
   reference under ``jax.default_matmul_precision("highest")`` (GAE scan,
   LSTM sequence forward and gradient, entity self-attention).
3. headline: the bench model (2x256 MLP into a 256-wide LSTM, bf16, toy
   env, 16,384 worlds, 32 steps per update in 2 BPTT chunks), built with
   ``init_training`` on the GPU and run as a jitted, donated
   ``update_iter`` for a few updates.
4. pbt: the config-#4 population (8 trained + 4 past policies, 8,192 duel
   worlds x 2 agents, 25/50/25 self/cross/past play, lr explored): two
   updates, one ``eval_elo`` and one ``update_population``.

``--four-cards`` runs only the sharded check: the PBT config on a
MeshConfig(data=2, policy=2) mesh (manual learn and collect regions)
against the same configuration on one card, in fp32 at highest precision.

Times printed here are smoke readings, not benchmarks. The last line of
standard output is one JSON object; the script exits non-zero, printing
no result, when JAX finds no GPU or any phase fails.

Run: python chip_smoke.py [--four-cards]
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*args):
    print(*args, flush=True)


def max_err(got, want):
    """(max |got - want|, max |want|) over all leaves, in float64."""
    err, scale = 0.0, 0.0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        err = max(err, float(np.max(np.abs(g - w))))
        scale = max(scale, float(np.max(np.abs(w))))
    return err, scale


def check(name, got, want, rel_tol, reason, abs_tol=None):
    """Max error against ``abs_tol``, or else ``rel_tol`` times the
    reference's magnitude."""
    err, scale = max_err(got, want)
    tol = abs_tol if abs_tol is not None else rel_tol * max(scale, 1.0)
    ok = err <= tol and all(
        np.isfinite(np.asarray(g, np.float32)).all()
        for g in jax.tree.leaves(got))
    log(f"  {name}: max_err={err:.3e} tol={tol:.3e} ({reason}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_err {err:.3e} > tol {tol:.3e}")


def numpy_gae(gamma, lam, rewards, values, dones, bootstrap):
    adv = np.zeros(rewards.shape, np.float64)
    next_adv = np.zeros(bootstrap.shape, np.float64)
    next_val = bootstrap.astype(np.float64)
    for t in reversed(range(rewards.shape[0])):
        live = ~dones[t]
        delta = rewards[t] + gamma * np.where(live, next_val, 0) - values[t]
        next_adv = delta + gamma * lam * np.where(live, next_adv, 0)
        adv[t] = next_adv
        next_val = values[t].astype(np.float64)
    return adv


def reference_phase(n=16384):
    from madrona_learn_tpu.models.attention import SelfAttention
    from madrona_learn_tpu.models.lstm import lstm_sequence
    from madrona_learn_tpu.ops.gae import compute_advantages

    log("[reference]")
    rng = np.random.default_rng(0)

    # GAE scan, T=32 over N=16,384 agents, against a float64 numpy loop.
    T, N = 32, n
    shape = (2, T // 2, 1, N, 1)
    rewards = rng.normal(size=shape).astype(np.float32)
    values = rng.normal(size=shape).astype(np.float32)
    dones = rng.random(shape) < 0.05
    boot = rng.normal(size=(1, N, 1)).astype(np.float32)
    got = jax.jit(compute_advantages, static_argnums=(0, 1))(
        0.99, 0.95, rewards, values, dones, boot)
    want = numpy_gae(0.99, 0.95, rewards.reshape(T, N),
                     values.reshape(T, N), dones.reshape(T, N),
                     boot.reshape(N))
    check(f"gae T=32 N={N} fp32", np.asarray(got).reshape(T, N), want,
          1e-5, "summation order")

    # LSTM sequence (the update pass's recurrence), N=16,384, H=256, T=16:
    # the bf16 model path against fp32 at highest precision.
    T, N, H = 16, n, 256
    xp = rng.normal(size=(T, N, 4 * H)).astype(np.float32)
    ends = rng.random((T, N, 1)) < 0.05
    wr = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = rng.normal(size=(4 * H,)).astype(np.float32)
    c0 = rng.normal(size=(N, H)).astype(np.float32)
    h0 = np.tanh(rng.normal(size=(N, H))).astype(np.float32)
    probe = rng.normal(size=(T, N, H)).astype(np.float32)
    args32 = [jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
              for a in (xp, wr, b, c0, h0)]
    args16 = [a.astype(jnp.bfloat16) for a in args32]

    def loss(xp, wr, b, c0, h0):
        ys = lstm_sequence(xp, ends, wr, b, c0, h0)
        return jnp.sum(ys.astype(jnp.float32) * probe)

    fwd = jax.jit(lambda *a: lstm_sequence(a[0], ends, *a[1:]))
    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))
    got_f, got_g = fwd(*args16), grad(*args16)
    with jax.default_matmul_precision("highest"):
        want_f = jax.jit(lambda *a: lstm_sequence(a[0], ends, *a[1:]))(
            *args32)
        want_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args32)
    check(f"lstm fwd N={N} H=256 T=16 bf16", got_f, want_f, 3e-2,
          "bf16 operands and state")
    for name, g, w in zip(("x_proj", "w_r", "bias", "c0", "h0"),
                          got_g, want_g):
        check(f"lstm grad d{name} bf16", g, w, 5e-2,
              "bf16 operands and state")

    # Entity self-attention module in fp32: default GPU matmuls (TF32)
    # against highest precision.
    for B, S, heads, hd in [(4, 8, 2, 32), (3, 17, 4, 64), (4, 11, 2, 32),
                            (3, 5, 4, 64), (2, 256, 2, 32), (1, 300, 4, 64),
                            (3, 130, 2, 32)]:
        net = SelfAttention(num_heads=heads, qkv_features=heads * hd,
                            out_features=24, dtype=jnp.float32)
        x = jnp.asarray(rng.normal(size=(B, S, 24)), jnp.float32)
        params = net.init(jax.random.PRNGKey(0), x)
        got = jax.jit(net.apply)(params, x)
        with jax.default_matmul_precision("highest"):
            want = jax.jit(net.apply)(params, x)
        check(f"attention B={B} S={S} heads={heads} d={hd} fp32", got, want,
              1e-2, "TF32 in fp32 products")


def memory_line(dev):
    stats = dev.memory_stats() or {}
    return (f"bytes_in_use={stats.get('bytes_in_use')} "
            f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def assert_finite_loss(mgr, what):
    loss = np.asarray(jax.device_get(mgr.metrics.metrics["Loss"].mean))
    if not np.isfinite(loss).all():
        raise AssertionError(f"{what}: non-finite loss {loss}")
    return loss


def headline_phase(num_worlds=None):
    from bench import NUM_WORLDS, STEPS_PER_UPDATE, build_manager

    num_worlds = num_worlds or NUM_WORLDS
    log("[headline]")
    t0 = time.perf_counter()
    mgr = build_manager(jnp.bfloat16, num_worlds)
    jax.block_until_ready(mgr)
    log(f"  init_training: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    compiled = update.lower(mgr).compile()
    log(f"  compile: {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")

    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        mgr = compiled(mgr)
        jax.block_until_ready(mgr)
        times.append(time.perf_counter() - t0)
    loss = assert_finite_loss(mgr, "headline")
    steady = times[1:]
    ms = 1e3 * sum(steady) / len(steady)
    log(f"  smoke reading (not a benchmark): {ms:.2f} ms/update over "
        f"{len(steady)} updates after the first = "
        f"{num_worlds * STEPS_PER_UPDATE / (ms / 1e3):.0f} env-steps/s; "
        f"loss {loss.ravel().tolist()}")
    log(f"  {memory_line(jax.devices()[0])}")


def pbt_phase(num_worlds=8192):
    import madrona_learn_tpu as mlt
    from benchmarks.configs_bench import pbt_manager

    log("[pbt]")
    t0 = time.perf_counter()
    mgr = pbt_manager(num_worlds, num_train=8, num_past=4,
                      portions=(0.25, 0.5, 0.25), seed=3, explore=True,
                      dtype=jnp.bfloat16)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    for _ in range(2):
        mgr = update(mgr)
    loss = assert_finite_loss(mgr, "pbt")
    log(f"  init + compile + 2 updates: {time.perf_counter() - t0:.1f} s; "
        f"loss {np.round(loss.ravel(), 4).tolist()}")

    elo_before = np.asarray(jax.device_get(mgr.state.policy_states.mmr.elo))
    t0 = time.perf_counter()
    mgr, deltas = mlt.eval_elo(
        mgr, num_eval_steps=32,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))
    mgr = mlt.update_population(mgr, deltas)
    elo_after = np.asarray(jax.device_get(mgr.state.policy_states.mmr.elo))
    log(f"  eval_elo + update_population: {time.perf_counter() - t0:.1f} s")
    log(f"  elo before {np.round(elo_before, 1).tolist()}")
    log(f"  elo after  {np.round(elo_after, 1).tolist()}")
    if not (np.isfinite(elo_after).all()
            and np.any(elo_after != elo_before)):
        raise AssertionError("Elo vector did not change or is not finite")
    log(f"  {memory_line(jax.devices()[0])}")


def four_card_phase(num_worlds=8192):
    """The PBT config placed on a data=2 x policy=2 mesh of 4 cards by
    ``shard_training_manager`` against the same config on one card; then
    the same population with the mesh in its TrainConfig, which runs the
    manual learn and collect regions."""
    import madrona_learn_tpu as mlt
    from benchmarks.configs_bench import pbt_manager
    from madrona_learn_tpu.parallel.mesh import (
        make_mesh, shard_training_manager)

    log("[four-cards]")
    devices = jax.devices()
    if len(devices) < 4:
        raise AssertionError(f"needs 4 GPUs, found {len(devices)}")
    mesh_cfg = mlt.MeshConfig(data=2, policy=2)
    mesh = make_mesh(mesh_cfg, devices[:4])

    def build(cfg_mesh=None):
        return pbt_manager(num_worlds, num_train=8, num_past=4,
                           portions=(0.25, 0.5, 0.25), seed=3, explore=True,
                           dtype=jnp.float32, mesh=cfg_mesh)

    def run(mgr):
        update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
        for _ in range(2):
            mgr = update(mgr)
        return mgr

    def memory(what):
        for i, dev in enumerate(devices[:4]):
            log(f"  {what} device {i}: {memory_line(dev)}")

    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        mgr = run(build())
        loss_1 = assert_finite_loss(mgr, "one card")
        params_1 = jax.device_get(mgr.state.policy_states.params)
        del mgr
        log(f"  one card: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        mgr = run(shard_training_manager(build(), mesh))
        loss_4 = assert_finite_loss(mgr, "four cards")
        params_4 = jax.device_get(mgr.state.policy_states.params)
        log(f"  four cards: {time.perf_counter() - t0:.1f} s")
        memory("sharded")
        del mgr

        t0 = time.perf_counter()
        mgr = run(shard_training_manager(build(mesh_cfg), mesh))
        loss_m = assert_finite_loss(mgr, "four cards, manual regions")
        log(f"  four cards, manual regions: {time.perf_counter() - t0:.1f} "
            f"s; loss {loss_m.ravel().tolist()}")
        memory("manual regions")

    log(f"  loss one card   {loss_1.ravel().tolist()}")
    log(f"  loss four cards {loss_4.ravel().tolist()}")
    check("loss, 4 cards vs 1", loss_4, loss_1, 1e-3,
          "fp32; cross-device reduction order")
    # Adam moves each parameter by at most ~lr per update whatever the
    # gradient's size, so a near-zero gradient whose sign depends on the
    # reduction order can differ by up to 2 lr per update.
    check("params after 2 updates, 4 cards vs 1", params_4, params_1, None,
          "fp32; Adam step bound 2 lr per update", abs_tol=2 * 1e-3 * 2)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded check")
    args = parser.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX runs on {dev.platform})",
              file=sys.stderr)
        return 1

    from bench import gpu_name_and_power_limit
    from madrona_learn_tpu.utils.platform import use_checkout_compile_cache

    use_checkout_compile_cache()
    log("[device]")
    log(f"  {dev.device_kind} x {len(jax.devices())}")
    log(f"  {gpu_name_and_power_limit()}")

    if args.four_cards:
        four_card_phase()
    else:
        reference_phase()
        headline_phase()
        pbt_phase()

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
