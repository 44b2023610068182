"""Platform contracts: the package trains with only JAX, numpy, scipy,
optax, chex and einops; the compile cache lands where the scripts say;
the GPU smoke script refuses to run without a GPU; CPU-only pieces refuse
other backends with a clear error."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from madrona_learn_tpu.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT_SCRIPT = r"""
import sys

BLOCKED = {"flax", "orbax", "msgpack", "rich", "yaml", "tensorboard",
           "tensorstore", "treescope", "etils"}


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked optional dependency: {name}")
        return None


sys.meta_path.insert(0, Blocker())

import jax
import jax.numpy as jnp
import numpy as np

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu.models import (
    ActorCritic, BackboneShared, DenseLayerCritic, DenseLayerDiscreteActor,
    DictActor, LSTM, MLP, RecurrentBackboneEncoder)

num_worlds = 16
actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
dtype = jnp.float32
ac = ActorCritic(
    backbone=BackboneShared(
        prefix=lambda obs, train: jnp.concatenate(
            [obs["delta"], obs["time"]], axis=-1),
        encoder=RecurrentBackboneEncoder(
            net=MLP(num_channels=16, num_layers=1, dtype=dtype),
            rnn=LSTM(num_hidden_channels=16, num_layers=1, dtype=dtype))),
    actor=DictActor(heads={"move": DenseLayerDiscreteActor(
        cfg=actions["move"], dtype=dtype)}),
    critic=DenseLayerCritic(dtype=dtype))
cfg = mlt.TrainConfig(
    num_worlds=num_worlds, num_agents_per_world=1, num_updates=1,
    actions=actions, steps_per_update=8, num_bptt_chunks=2, lr=1e-3,
    gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=1,
    algo=mlt.PPOConfig(num_epochs=1, minibatch_size=num_worlds,
                       clip_coef=0.2, value_loss_coef=0.5,
                       entropy_coef=0.01, max_grad_norm=0.5),
    dreamer_v3_critic=False)
mgr = mlt.init_training(
    None, cfg, make_toy_env(ToyEnvConfig(num_worlds=num_worlds,
                                         episode_len=10, grid_size=4)),
    mlt.Policy(actor_critic=ac), init_sim_ctrl=jnp.zeros((1,), jnp.int32))
mgr = jax.jit(lambda m: m.update_iter(), donate_argnums=0)(mgr)
loss = np.asarray(mgr.metrics.metrics["Loss"].mean)
assert np.isfinite(loss).all(), loss
leaked = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
assert not leaked, leaked
print("UPDATE_OK", loss.ravel().tolist())
"""


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def test_update_runs_without_optional_dependencies(tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(_BLOCKED_IMPORT_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=_clean_env(), cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "UPDATE_OK" in out.stdout


def test_compile_cache_in_checkout_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = platform.use_checkout_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_untouched_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert platform.use_checkout_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_checkout_cache_dir_is_ignored_by_git():
    out = subprocess.run(
        ["git", "check-ignore", "-q", ".jax_cache/x"], cwd=REPO)
    assert out.returncode == 0


def test_compute_dtype_follows_backend(monkeypatch):
    assert platform.compute_dtype() == jnp.float32
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.compute_dtype() == jnp.bfloat16
    assert platform.compute_dtype(jnp.float16) == jnp.float16


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_refuses_to_run_without_gpu(args):
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", *args], capture_output=True,
        text=True, env=_clean_env(), cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_native_sim_ffi_refuses_non_cpu_backend(monkeypatch):
    from madrona_learn_tpu.envs.native_sim import NativeSimConfig
    from madrona_learn_tpu.envs.native_sim_ffi import make_native_sim_ffi

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="B1"):
        make_native_sim_ffi(NativeSimConfig(num_worlds=4, episode_len=8,
                                            grid_size=4))


def test_bench_device_record_requires_gpu():
    sys.path.insert(0, REPO)
    import bench

    with pytest.raises(SystemExit, match="no GPU"):
        bench.device_record()


@pytest.mark.parametrize("phase,kwargs", [
    ("reference_phase", {"n": 256}),
    ("headline_phase", {"num_worlds": 256}),
    ("pbt_phase", {"num_worlds": 128}),
    ("four_card_phase", {"num_worlds": 128}),
])
def test_chip_smoke_phase_at_small_size(phase, kwargs, monkeypatch):
    """Each phase of the GPU smoke script, at a small size on the CPU (the
    four-card phase on 4 of the virtual devices): the same checks, and
    their tolerances, hold."""
    monkeypatch.chdir(REPO)
    sys.path.insert(0, REPO)
    import chip_smoke

    getattr(chip_smoke, phase)(**kwargs)
