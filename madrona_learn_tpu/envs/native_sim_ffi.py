"""Native simulator as a true XLA custom call (jax.ffi).

The companion to envs/native_sim.py: instead of a host callback, the C++
step registers as an XLA FFI handler and becomes a node *inside* the
compiled program — zero Python in the loop, the integration shape a
Madrona-style engine uses on CPU-attached backends (the reference's engine
enters the jitted rollout loop as exactly such a custom call; reference:
rollouts.py:929 + SURVEY.md section 2b).

CPU-platform only: XLA runs the handler on the host, and construction
raises on any other backend. On a GPU use the ``pure_callback`` bridge
(envs/native_sim.py) or keep the env on-device (envs/toy_env.py); a CUDA
step handler is ROADMAP item B1.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from .native_sim import NativeSimConfig, _NATIVE_DIR

_FFI_LIB_PATH = os.path.join(_NATIVE_DIR, "libbatch_sim_ffi.so")
_registered = False


def _ensure_registered():
    global _registered
    if _registered:
        return
    if not os.path.exists(_FFI_LIB_PATH):
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libbatch_sim_ffi.so"],
            check=True, capture_output=True)

    lib = ctypes.CDLL(_FFI_LIB_PATH)
    lib.batch_sim_step_ffi_handler.restype = ctypes.c_void_p
    handler = lib.batch_sim_step_ffi_handler()
    jax.ffi.register_ffi_target(
        "madrona_learn_tpu_batch_sim_step",
        jax.ffi.pycapsule(handler),
        platform="cpu",
    )
    _registered = True


def make_native_sim_ffi(cfg: NativeSimConfig):
    """``sim_fns`` whose step is an XLA custom call into the C++ simulator.

    Raises RuntimeError off the CPU backend: only a CPU FFI target is
    registered, so a GPU program could not lower the call."""
    backend = jax.default_backend()
    if backend != "cpu":
        raise RuntimeError(
            f"make_native_sim_ffi registers a CPU-only FFI target and cannot "
            f"run on the {backend!r} backend; use envs.make_native_sim (the "
            f"pure_callback bridge) there. A CUDA step handler is ROADMAP "
            f"item B1.")
    _ensure_registered()

    # init reuses the ctypes path (runs once, outside the hot loop).
    from .native_sim import make_native_sim

    init_fn = make_native_sim(cfg)["init"]

    n = cfg.batch_size
    threads = cfg.num_threads or (os.cpu_count() or 1)

    result_types = (
        jax.ShapeDtypeStruct((n, 2), jnp.int32),   # pos
        jax.ShapeDtypeStruct((n, 2), jnp.int32),   # target
        jax.ShapeDtypeStruct((n, 1), jnp.int32),   # t
        jax.ShapeDtypeStruct((n, 1), jnp.int32),   # rng_ctr
        jax.ShapeDtypeStruct((n, 2), jnp.float32),  # obs delta
        jax.ShapeDtypeStruct((n, 1), jnp.float32),  # obs time
        jax.ShapeDtypeStruct((n, 1), jnp.float32),  # rewards
        jax.ShapeDtypeStruct((n, 1), jnp.uint8),    # dones
    )

    def step_fn(step_input):
        state = step_input["state"]
        actions = step_input["actions"]["move"].astype(jnp.int32)
        resets = jnp.repeat(
            step_input["resets"].astype(jnp.int32),
            n // step_input["resets"].shape[0], axis=0)

        call = jax.ffi.ffi_call(
            "madrona_learn_tpu_batch_sim_step", result_types)
        (pos, tgt, t, rng_ctr, obs_delta, obs_time, rewards, dones) = call(
            state["pos"], state["target"], state["t"], state["rng_ctr"],
            actions, resets,
            grid_size=np.int32(cfg.grid_size),
            episode_len=np.int32(cfg.episode_len),
            seed=np.int64(cfg.seed),
            num_threads=np.int32(threads),
        )

        return {
            "state": {
                "pos": pos, "target": tgt, "t": t, "rng_ctr": rng_ctr},
            "obs": {"delta": obs_delta, "time": obs_time},
            "rewards": rewards,
            "dones": dones.astype(jnp.bool_),
            "pbt": {"episode_results": jnp.zeros(
                (cfg.num_worlds, 1), jnp.int32)},
        }

    return {"init": init_fn, "step": step_fn}
