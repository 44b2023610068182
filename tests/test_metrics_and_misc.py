"""Metrics machinery, writers, fitness updates, sim snapshots, and
checkpoint population re-slicing."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from madrona_learn_tpu.struct import FrozenDict
from jax import random

import madrona_learn_tpu as mlt
from madrona_learn_tpu.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu.ops.metrics import Metric, TrainingMetrics
from madrona_learn_tpu.pbt import PBTMatchmakeConfig, pbt_update_fitness
from madrona_learn_tpu.rollouts import RolloutConfig, RolloutState
from madrona_learn_tpu.train_state import (
    MovingEpisodeScore,
    PolicyState,
    TrainStateManager,
)

from test_train_e2e import run_training


def test_metric_merge_equals_bulk():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(1000,)).astype(np.float32)

    bulk = Metric.init_from_data(False, jnp.asarray(data))
    a = Metric.init_from_data(False, jnp.asarray(data[:300]))
    b = Metric.init_from_data(False, jnp.asarray(data[300:]))
    merged = a.merge(b)

    np.testing.assert_allclose(float(merged.mean), float(bulk.mean),
                               rtol=1e-5)
    np.testing.assert_allclose(float(merged.m2), float(bulk.m2), rtol=1e-4)
    assert float(merged.min) == float(bulk.min)
    assert float(merged.max) == float(bulk.max)
    assert int(merged.count) == int(bulk.count)


def test_masked_metric():
    data = jnp.asarray([1.0, 2.0, 100.0, 3.0])
    mask = jnp.asarray([True, True, False, True])
    m = Metric.init_from_data_masked(False, data, mask)
    assert float(m.mean) == 2.0
    assert float(m.max) == 3.0
    assert int(m.count) == 3


def test_training_metrics_ring_buffer_and_logging(tmp_path, capsys):
    metrics = TrainingMetrics.create(
        {"A": Metric.init(True), "B": Metric.init(False)},
        buffer_size=3, start_update_idx=0, num_policies=2)

    @jax.jit
    def record(metrics, data_a):
        return metrics.record({"A": data_a}).advance()

    for i in range(4):  # wraps the size-3 ring buffer
        metrics = record(metrics, jnp.full((2, 8), float(i)))

    host = jax.tree.map(np.asarray, metrics)
    host.pretty_print()
    out = capsys.readouterr().out
    assert "A:" in out and "Avg" in out

    writer = mlt.TensorboardWriter(str(tmp_path / "tb"))
    host.tensorboard_log(0, writer)
    writer.flush()
    files = os.listdir(str(tmp_path / "tb"))
    assert any("tfevents" in f for f in files)


def test_pbt_update_fitness_moves_toward_scores():
    mm_cfg = PBTMatchmakeConfig.setup(
        num_current_policies=2,
        num_past_policies=0,
        num_teams=1,
        team_size=1,
        sim_batch_size=8,
        self_play_portion=1.0,
        cross_play_portion=0.0,
        past_play_portion=0.0,
        static_play_portion=0.0,
    )

    policy_states = PolicyState(
        apply_fn=None,
        rnn_reset_fn=None,
        params={},
        batch_stats={},
        obs_preprocess=None,
        obs_preprocess_state={},
        reward_hyper_params=None,
        get_episode_scores_fn=lambda er: er[0].astype(jnp.float32),
        episode_score=MovingEpisodeScore(
            mean=jnp.zeros(2), var=jnp.zeros(2), N=jnp.zeros(2, jnp.int32)),
        mmr=None,
    )

    # Policy 0 owns agents 0-3 (score 10), policy 1 owns agents 4-7 (score 2).
    assignments = jnp.repeat(jnp.arange(2), 4)[:, None]
    dones = jnp.ones((8, 1), jnp.bool_)
    episode_results = jnp.concatenate(
        [jnp.full((4, 1), 10.0), jnp.full((4, 1), 2.0)]).astype(jnp.float32)

    updated = pbt_update_fitness(
        assignments, policy_states, dones, episode_results, mm_cfg)
    means = np.asarray(updated.episode_score.mean)
    assert means[0] > means[1] > 0


def test_sim_state_snapshots():
    """get_ckpts/load_ckpts round trip restores exact sim state."""
    env_cfg = ToyEnvConfig(num_worlds=8, episode_len=10, grid_size=5, seed=4)
    sim_fns = make_toy_env(env_cfg)

    actions_cfg = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    rollout_cfg = RolloutConfig.setup(
        num_current_policies=1, num_past_policies=0, num_teams=1,
        team_size=1, sim_batch_size=8, actions_cfg=actions_cfg,
        self_play_portion=1.0, cross_play_portion=0.0, past_play_portion=0.0,
        static_play_portion=0.0)

    state = RolloutState.create(
        rollout_cfg=rollout_cfg,
        sim_fns=sim_fns,
        prng_key=random.PRNGKey(0),
        rnn_states=(),
        init_sim_ctrl=jnp.zeros((1,), jnp.int32),
    )

    ckpts = state.get_current_checkpoints()
    assert ckpts.shape == (8, 5)

    restored = state.load_checkpoints_into_sim(ckpts)
    np.testing.assert_array_equal(
        np.asarray(restored.sim_state["pos"]),
        np.asarray(state.sim_state["pos"]))
    np.testing.assert_array_equal(
        np.asarray(restored.cur_obs["delta"]),
        np.asarray(state.cur_obs["delta"]))


def test_wandb_writer_with_stub(tmp_path, monkeypatch):
    """WandbWriter mirrors scalars to wandb.log (exercised against a stub
    module so the optional dependency isn't required)."""
    import sys
    import types

    calls = {"init": [], "log": []}
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls["init"].append(kw)
    stub.log = lambda data, step=None: calls["log"].append((data, step))
    monkeypatch.setitem(sys.modules, "wandb", stub)

    from madrona_learn_tpu.utils.wandb import WandbWriter

    writer = WandbWriter(str(tmp_path / "wb"), config={"lr": 1e-3})
    writer.scalar("loss", 0.5, 3)
    writer.flush()

    assert calls["init"] and calls["init"][0]["sync_tensorboard"] is True
    assert calls["init"][0]["config"] == {"lr": 1e-3}
    assert calls["log"] == [({"loss": 0.5}, 3)]
    files = os.listdir(str(tmp_path / "wb"))
    assert any("tfevents" in f for f in files)


def test_all_pairs_underfill_warns():
    """An eval batch smaller than the pair list warns with the dropped-pair
    count; a sufficient batch stays silent."""
    import warnings as _warnings

    from madrona_learn_tpu.train import _build_all_pairs_assignments

    # 4 policies -> 16 pairings; batch of 8 (1v1) = 8 slots -> underfilled.
    with pytest.warns(UserWarning, match="underfilled"):
        a = _build_all_pairs_assignments(
            num_eval_policies=4, custom_policy_ids=[],
            sim_batch_size=16, num_teams=2, team_size=1)
    assert a.shape == (16,)

    # 32 slots >= 16 pairings -> no warning, every pairing present.
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        a = _build_all_pairs_assignments(
            num_eval_policies=4, custom_policy_ids=[],
            sim_batch_size=64, num_teams=2, team_size=1)
    pairs = set(map(tuple, np.asarray(a).reshape(-1, 2)))
    assert pairs == {(x, y) for x in range(4) for y in range(4)}


def test_slice_checkpoint(tmp_path):
    mgr, _ = run_training(num_updates=1, num_worlds=16, seed=31)
    ckpt_dir = str(tmp_path / "ck")
    mgr.save_ckpt(ckpt_dir)
    src = os.path.join(ckpt_dir, "1")
    dst = os.path.join(str(tmp_path), "sliced")

    TrainStateManager.slice_checkpoint(
        src, dst, train_select=np.asarray([0]), past_select=np.asarray([0]))

    import orbax.checkpoint as ocp
    loaded = ocp.PyTreeCheckpointer().restore(dst)
    # 1 train + 1 past copy in policy_states; train_states stay at 1.
    first_param = jax.tree.leaves(loaded["policy_states"]["params"])[0]
    assert first_param.shape[0] == 2
    first_train = jax.tree.leaves(loaded["train_states"])[0]
    assert first_train.shape[0] == 1
