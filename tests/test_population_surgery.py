"""CLI population surgery over PBT checkpoints: inspect / slice / best."""

import subprocess
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest

from test_pbt_e2e import NUM_PAST, NUM_TRAIN, build_training_mgr


@pytest.fixture(scope="module")
def pbt_ckpt(tmp_path_factory):
    mgr = build_training_mgr(seed=41)
    update = jax.jit(lambda m: m.update_iter(), donate_argnums=0)
    mgr = update(mgr)
    ckpt_dir = tmp_path_factory.mktemp("surgery")
    mgr.save_ckpt(str(ckpt_dir))
    return str(ckpt_dir / "1")


def _run(*argv):
    import os

    # CPU platform and a clean PYTHONPATH: surgery is host-side numpy work
    # and must not touch (or wait on) an accelerator backend.
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "scripts/population_surgery.py", *argv],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), timeout=300,
        env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_inspect(pbt_ckpt):
    out = _run("inspect", pbt_ckpt)
    assert f"policies: {NUM_TRAIN + NUM_PAST} total = {NUM_TRAIN} train" in out
    assert "elo (desc):" in out
    assert "params/policy:" in out


def test_slice(pbt_ckpt, tmp_path):
    dst = str(tmp_path / "sliced")
    _run("slice", pbt_ckpt, dst, "--train", "0,2", "--past", "1")

    loaded = ocp.PyTreeCheckpointer().restore(dst)
    first_param = jax.tree.leaves(loaded["policy_states"]["params"])[0]
    assert first_param.shape[0] == 3  # 2 train + 1 past
    first_train = jax.tree.leaves(loaded["train_states"])[0]
    assert first_train.shape[0] == 2


def test_best(pbt_ckpt, tmp_path):
    dst = str(tmp_path / "best")
    out = _run("best", pbt_ckpt, dst)
    assert "best train policy: p" in out

    loaded = ocp.PyTreeCheckpointer().restore(dst)
    first_param = jax.tree.leaves(loaded["policy_states"]["params"])[0]
    assert first_param.shape[0] == 1
