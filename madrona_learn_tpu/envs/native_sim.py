"""Native (C++) batched simulator integration through the sim contract.

This demonstrates the external-simulator path the reference's whole design
exists for: the native engine is opaque to the trainer and enters the jitted
rollout loop only as step callables (reference: rollouts.py:905-947, where
Madrona's C++/CUDA engine appears as an XLA custom call). Here the native sim
is the C++ gridworld in native/batch_sim.cpp, bridged with
``jax.pure_callback`` — the host-callback boundary a device-resident
program uses to talk to a CPU-side simulator; it works on every platform. The C++ step is stateless (all state
arrays flow through the callback), so the training loop stays functionally
pure, checkpointable, and deterministic.

The dynamics intentionally match ``envs/toy_env.py`` (same obs/action/reward
structure), so policies and tests can swap between pure-JAX and native sims.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbatch_sim.so")

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)

    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.batch_sim_init.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
        i32p, i32p, i32p, i32p, f32p, f32p,
    ]
    lib.batch_sim_step.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, i32p, i32p, i32p, f32p, f32p, f32p, u8p,
    ]
    _lib = lib
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


@dataclass(frozen=True)
class NativeSimConfig:
    num_worlds: int
    episode_len: int = 40
    grid_size: int = 8
    seed: int = 0
    num_threads: int = 0  # 0 = os.cpu_count()

    @property
    def batch_size(self) -> int:
        return self.num_worlds


def make_native_sim(cfg: NativeSimConfig):
    """Build ``sim_fns`` backed by the C++ batched simulator."""
    lib = _load_lib()
    n = cfg.batch_size
    threads = cfg.num_threads or (os.cpu_count() or 1)

    def _host_init():
        pos = np.empty((n, 2), np.int32)
        tgt = np.empty((n, 2), np.int32)
        t = np.empty((n, 1), np.int32)
        rng_ctr = np.empty((n, 1), np.int32)
        obs_delta = np.empty((n, 2), np.float32)
        obs_time = np.empty((n, 1), np.float32)
        lib.batch_sim_init(
            n, cfg.grid_size, cfg.seed,
            _ptr(pos, ctypes.c_int32), _ptr(tgt, ctypes.c_int32),
            _ptr(t, ctypes.c_int32), _ptr(rng_ctr, ctypes.c_int32),
            _ptr(obs_delta, ctypes.c_float), _ptr(obs_time, ctypes.c_float))
        return pos, tgt, t, rng_ctr, obs_delta, obs_time

    def _host_step(pos, tgt, t, rng_ctr, actions, resets):
        pos = np.ascontiguousarray(pos, np.int32)
        tgt = np.ascontiguousarray(tgt, np.int32)
        t = np.ascontiguousarray(t, np.int32)
        rng_ctr = np.ascontiguousarray(rng_ctr, np.int32)
        actions = np.ascontiguousarray(actions, np.int32)
        resets = np.ascontiguousarray(
            np.repeat(resets, n // resets.shape[0], axis=0), np.int32)

        pos_out = np.empty_like(pos)
        tgt_out = np.empty_like(tgt)
        t_out = np.empty_like(t)
        rng_out = np.empty_like(rng_ctr)
        obs_delta = np.empty((n, 2), np.float32)
        obs_time = np.empty((n, 1), np.float32)
        rewards = np.empty((n, 1), np.float32)
        dones = np.empty((n, 1), np.uint8)

        lib.batch_sim_step(
            n, cfg.grid_size, cfg.episode_len, cfg.seed, threads,
            _ptr(pos, ctypes.c_int32), _ptr(tgt, ctypes.c_int32),
            _ptr(t, ctypes.c_int32), _ptr(rng_ctr, ctypes.c_int32),
            _ptr(actions, ctypes.c_int32), _ptr(resets, ctypes.c_int32),
            _ptr(pos_out, ctypes.c_int32), _ptr(tgt_out, ctypes.c_int32),
            _ptr(t_out, ctypes.c_int32), _ptr(rng_out, ctypes.c_int32),
            _ptr(obs_delta, ctypes.c_float), _ptr(obs_time, ctypes.c_float),
            _ptr(rewards, ctypes.c_float), _ptr(dones, ctypes.c_uint8))

        return pos_out, tgt_out, t_out, rng_out, obs_delta, obs_time, \
            rewards, dones

    def init_fn():
        pos, tgt, t, rng_ctr, obs_delta, obs_time = _host_init()
        state = {
            "pos": jnp.asarray(pos),
            "target": jnp.asarray(tgt),
            "t": jnp.asarray(t),
            "rng_ctr": jnp.asarray(rng_ctr),
        }
        obs = {
            "delta": jnp.asarray(obs_delta),
            "time": jnp.asarray(obs_time),
        }
        return {"state": state, "obs": obs}

    result_shapes = (
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
        actions = step_input["actions"]["move"]
        resets = step_input["resets"]

        (pos, tgt, t, rng_ctr, obs_delta, obs_time, rewards,
         dones) = jax.pure_callback(
            _host_step, result_shapes,
            state["pos"], state["target"], state["t"], state["rng_ctr"],
            actions, resets,
            vmap_method="sequential")

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
