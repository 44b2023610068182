"""Two-process jax.distributed smoke test on CPU.

Validates the multi-host init path (parallel/distributed.py) without a pod:
two processes, 4 virtual CPU devices each, form one 8-device global mesh and
run a psum across it.
"""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

from madrona_learn_tpu.parallel import distributed

ok = distributed.init_multi_host(
    coordinator_address="127.0.0.1:29671",
    num_processes=2,
    process_id=proc_id,
)
assert ok

import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np

assert len(jax.devices()) == 8, jax.devices()
mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))

# Each process contributes its local shard of a global [8] array.
local = jnp.arange(4, dtype=jnp.float32) + 4 * proc_id
global_arr = jax.make_array_from_single_device_arrays(
    (8,), NamedSharding(mesh, P("data")),
    [jax.device_put(local[i:i+1], d) for i, d in enumerate(
        jax.local_devices())])

total = jax.jit(
    lambda x: jnp.sum(x),
    out_shardings=NamedSharding(mesh, P()))(global_arr)
result = float(jax.device_get(total))
assert result == sum(range(8)), result
print(f"proc {proc_id} OK: {result}", flush=True)
"""


_TRAIN_WORKER = r"""
import os, sys
proc_id = int(sys.argv[1]); ckpt_dir = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

from madrona_learn_tpu.parallel import distributed

assert distributed.init_multi_host(
    coordinator_address="127.0.0.1:29673", num_processes=2,
    process_id=proc_id)
assert len(jax.devices()) == 8

import jax.numpy as jnp
import numpy as np

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu.models import (
    ActorCritic, BackboneShared, DenseLayerCritic, DenseLayerDiscreteActor,
    DictActor, LSTM, MLP, RecurrentBackboneEncoder)
from madrona_learn_tpu.parallel import make_mesh, shard_training_manager

mesh_cfg = mlt.MeshConfig(data=4, policy=2)
mesh = make_mesh(mesh_cfg, jax.devices())

# 64 worlds (sim batch 128): the shard-major matchmaking layout divides at
# data=4 (past matches/shard 4 %% num_train 4 == 0), so the manual COLLECT
# region engages across the 2 processes — asserted below.
num_worlds = 64
actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
sim_fns = make_duel_env(ToyEnvConfig(
    num_worlds=num_worlds, episode_len=4, num_teams=2, team_size=1, seed=0))

dtype = jnp.float32
ac = ActorCritic(
    backbone=BackboneShared(
        prefix=lambda obs, train: jnp.concatenate(
            [obs["time"], obs["acc"]], axis=-1),
        encoder=RecurrentBackboneEncoder(
            net=MLP(num_channels=32, num_layers=1, dtype=dtype),
            rnn=LSTM(num_hidden_channels=16, num_layers=1, dtype=dtype))),
    actor=DictActor(heads={"move": DenseLayerDiscreteActor(
        cfg=actions["move"], dtype=dtype)}),
    critic=DenseLayerCritic(dtype=dtype))
policy = mlt.Policy(
    actor_critic=ac,
    obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
    get_episode_scores=lambda er: (
        jnp.where(er[0] == 0, 1.0, jnp.where(er[0] == 1, 0.0, 0.5)),
        jnp.where(er[0] == 0, 0.0, jnp.where(er[0] == 1, 1.0, 0.5))))

cfg = mlt.TrainConfig(
    num_worlds=num_worlds, num_agents_per_world=2, num_updates=3,
    actions=actions, steps_per_update=8, num_bptt_chunks=2, lr=1e-3,
    gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=1,
    mesh=mesh_cfg,
    algo=mlt.PPOConfig(
        num_epochs=1, minibatch_size=2, clip_coef=0.2, value_loss_coef=0.5,
        entropy_coef=0.01, max_grad_norm=0.5),
    pbt=mlt.PBTConfig(
        num_teams=2, team_size=1, num_train_policies=4, num_past_policies=2,
        self_play_portion=0.25, cross_play_portion=0.5,
        past_play_portion=0.25),
    dreamer_v3_critic=False)

mgr = mlt.init_training(None, cfg, sim_fns, policy,
                        init_sim_ctrl=jnp.zeros((1,), jnp.int32))
mgr = shard_training_manager(mgr, mesh)

from madrona_learn_tpu.rollouts import RolloutManager
assert RolloutManager(
    mgr.cfg, mgr.rollout,
    mgr.state.policy_states)._manual_collect_enabled(mgr.rollout), (
    "manual collect region must engage in the multiprocess run")

update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
mgr = update(mgr)
mgr = update(mgr)
jax.block_until_ready(mgr.state.train_states.opt_state)


def local_shards(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, jax.Array) and not jnp.issubdtype(
                leaf.dtype, jax.dtypes.prng_key):
            out[jax.tree_util.keystr(path)] = [

                np.asarray(s.data) for s in leaf.addressable_shards]
    return out


pre_params = local_shards(mgr.state.policy_states.params)
pre_opt = local_shards(mgr.state.train_states.opt_state)

mgr.save_ckpt(ckpt_dir)  # collective: every process writes its shards
restored = mgr.load_ckpt(os.path.join(ckpt_dir, "2"))

post_params = local_shards(restored.state.policy_states.params)
post_opt = local_shards(restored.state.train_states.opt_state)
assert pre_params.keys() == post_params.keys() and pre_params
for k in pre_params:
    for a, b in zip(pre_params[k], post_params[k]):
        np.testing.assert_array_equal(a, b)
for k in pre_opt:
    for a, b in zip(pre_opt[k], post_opt[k]):
        np.testing.assert_array_equal(a, b)
assert int(restored.update_idx) == 2

# Training continues from the restored sharded state.
restored = update(restored)
jax.block_until_ready(restored.state.train_states.opt_state)
rewards = np.asarray(jax.device_get(
    restored.metrics.metrics["Rewards"].mean))
assert np.isfinite(rewards).all()
print(f"proc {proc_id} TRAIN OK", flush=True)
"""


def _run_two_process(tmp_path, worker_src, extra_args=()):
    worker = tmp_path / "worker.py"
    worker.write_text(worker_src)

    # jax.distributed.initialize must run before any backend starts in
    # each worker, so the workers get a clean PYTHONPATH.
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO_ROOT
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), *map(str, extra_args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for i in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outputs))
    return procs, outputs


@pytest.mark.slow
def test_two_process_training_checkpoint_resume(tmp_path):
    """Full sharded PBT training across 2 real processes: init -> 2 sharded
    updates -> collective checkpoint save -> restore -> continue. Restored
    per-process shards must be bit-identical to the pre-save state."""
    procs, outputs = _run_two_process(
        tmp_path, _TRAIN_WORKER, extra_args=[str(tmp_path / "ckpt")])
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"proc {i} TRAIN OK" in out


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    # jax.distributed.initialize must run before any backend starts in
    # each worker, so the workers get a clean PYTHONPATH.
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO_ROOT
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for i in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outputs))

    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK: 28.0" in out
