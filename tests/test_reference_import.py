"""Checkpoint migration from the reference framework.

Builds the matched MLP+LSTM actor-critic in BOTH frameworks, converts the
reference's trained params with ``convert_reference_params``, and asserts
the two stacks score identical sequences identically (log-probs,
entropies, critic values) — the property a reference user migrating a
trained policy actually needs. Also round-trips a real reference orbax
checkpoint directory through ``import_reference_checkpoint``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REF_SRC = "/root/reference/src"

if not os.path.isdir(REF_SRC):
    pytest.skip("reference tree unavailable", allow_module_level=True)

# Pure aliases for the reference's older-API calls (no behavior change).
if not hasattr(jax, "tree_map"):
    jax.tree_map = jax.tree.map
if not hasattr(jax, "tree_leaves"):
    jax.tree_leaves = jax.tree.leaves

CH = 32
T, N = 6, 8
FEATS = 3  # delta(2) + time(1)


def _build_ref_ac():
    sys.path.insert(0, REF_SRC)
    import flax
    import flax.linen as nn
    import madrona_learn as ml
    from madrona_learn_tpu.struct import FrozenDict
    from jax import random
    from madrona_learn.models import (
        MLP, DenseLayerCritic, DenseLayerDiscreteActor)
    from madrona_learn.rnn import LSTM as RefLSTM

    class RefDictDists(flax.struct.PyTreeNode):
        dists: FrozenDict

        def sample(self, prng_key):
            keys = random.split(prng_key, len(self.dists))
            actions, log_probs = {}, {}
            for key, (name, dist) in zip(
                    keys, sorted(self.dists.items())):
                actions[name], log_probs[name] = dist.sample(key)
            return FrozenDict(actions), FrozenDict(log_probs)

        def best(self):
            return FrozenDict(
                {n: d.best() for n, d in self.dists.items()})

        def action_stats(self, all_actions):
            lp, ent = {}, {}
            for n, d in self.dists.items():
                lp[n], ent[n] = d.action_stats(all_actions[n])
            return FrozenDict(lp), FrozenDict(ent)

    class RefDictActor(nn.Module):
        heads: dict

        @nn.compact
        def __call__(self, features, train=False):
            return RefDictDists(FrozenDict({
                n: h(features, train=train)
                for n, h in self.heads.items()}))

    actions = {"move": ml.DiscreteActionsConfig(actions_num_buckets=[5])}
    return ml.ActorCritic(
        backbone=ml.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=ml.RecurrentBackboneEncoder(
                net=MLP(num_channels=CH, num_layers=2, dtype=jnp.float32),
                rnn=RefLSTM(num_hidden_channels=CH, num_layers=1,
                            dtype=jnp.float32))),
        actor=RefDictActor(heads={"move": DenseLayerDiscreteActor(
            cfg=actions["move"], dtype=jnp.float32)}),
        critic=DenseLayerCritic(dtype=jnp.float32))


def _build_our_ac():
    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.models import (
        ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, LSTM, MLP,
        RecurrentBackboneEncoder)

    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    return ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(num_channels=CH, num_layers=2, dtype=jnp.float32),
                rnn=LSTM(num_hidden_channels=CH, num_layers=1,
                         dtype=jnp.float32))),
        actor=DictActor(heads={"move": DenseLayerDiscreteActor(
            cfg=actions["move"], dtype=jnp.float32)}),
        critic=DenseLayerCritic(dtype=jnp.float32))


def _ref_trained_variables(ref_ac, seed=0):
    """Init the reference model and perturb params to random nonzero
    values (a stand-in for trained weights, deterministic)."""
    obs = {"delta": jnp.ones((N, 2)), "time": jnp.ones((N, 1))}
    st = ref_ac.init_recurrent_state(N)
    variables = ref_ac.init(
        jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1), st, obs,
        method="rollout")
    rng = np.random.default_rng(seed + 2)
    return jax.tree.map(
        lambda l: jnp.asarray(
            rng.normal(scale=0.3, size=l.shape), l.dtype), variables)


def _sequence_inputs(seed=5):
    rng = np.random.default_rng(seed)
    obs = {
        "delta": jnp.asarray(rng.normal(size=(T, N, 2)), jnp.float32),
        "time": jnp.asarray(rng.normal(size=(T, N, 1)), jnp.float32),
    }
    breaks = jnp.asarray(rng.random((T, N, 1)) < 0.2)
    actions = {"move": jnp.asarray(
        rng.integers(0, 5, size=(T, N, 1)), jnp.int32)}
    return obs, breaks, actions


def test_converted_params_score_sequences_identically():
    from madrona_learn_tpu.compat import convert_reference_params

    ref_ac = _build_ref_ac()
    our_ac = _build_our_ac()

    ref_vars = _ref_trained_variables(ref_ac)
    our_vars = convert_reference_params(ref_vars)

    # Structure must match our own init exactly.
    obs0 = {"delta": jnp.ones((N, 2)), "time": jnp.ones((N, 1))}
    our_init = our_ac.init(
        jax.random.PRNGKey(9), jax.random.PRNGKey(10),
        our_ac.init_recurrent_state(N), obs0, method="rollout")
    got_tree = jax.tree.map(jnp.shape, our_vars)
    want_tree = jax.tree.map(jnp.shape, jax.tree.map(lambda x: x, our_init))
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree), (
        got_tree, want_tree)

    obs, breaks, actions = _sequence_inputs()

    ref_out = ref_ac.apply(
        ref_vars, ref_ac.init_recurrent_state(N), breaks, actions, obs,
        train=False, method="update")
    our_out = our_ac.apply(
        our_vars, our_ac.init_recurrent_state(N), breaks, actions, obs,
        train=False, method="update")

    for key in ("log_probs", "entropies"):
        np.testing.assert_allclose(
            np.asarray(ref_out[key]["move"]),
            np.asarray(our_out[key]["move"]),
            rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(
        np.asarray(ref_out["critic"]), np.asarray(our_out["critic"]),
        rtol=1e-5, atol=1e-5)


def test_import_reference_checkpoint_roundtrip(tmp_path):
    """A real reference orbax checkpoint directory restores and converts."""
    import orbax.checkpoint as ocp

    from madrona_learn_tpu.compat import import_reference_checkpoint

    ref_ac = _build_ref_ac()
    ref_vars = _ref_trained_variables(ref_ac, seed=7)

    ckpt_dir = str(tmp_path / "ref_ckpt")
    ocp.PyTreeCheckpointer().save(ckpt_dir, jax.device_get(ref_vars))

    converted = import_reference_checkpoint(ckpt_dir)

    our_ac = _build_our_ac()
    obs, breaks, actions = _sequence_inputs(seed=8)
    out = our_ac.apply(
        converted, our_ac.init_recurrent_state(N), breaks, actions, obs,
        train=False, method="update")
    assert np.isfinite(np.asarray(out["critic"])).all()

    # Against the in-memory conversion: identical.
    from madrona_learn_tpu.compat import convert_reference_params
    direct = convert_reference_params(ref_vars)
    for a, b in zip(jax.tree.leaves(converted), jax.tree.leaves(direct)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_obs_normalizer_state_migrates_unchanged():
    """The EMA observation-normalizer state trees are key-for-key
    identical between frameworks (ops/ema.py mirrors the reference's
    moving_avg semantics), so convert_reference_params passes them
    through and OUR preprocess reproduces the reference's normalized
    observations on a reference-trained state."""
    sys.path.insert(0, REF_SRC)
    import madrona_learn as ml

    import madrona_learn_tpu as mlt
    from madrona_learn_tpu.compat import convert_reference_params

    rng = np.random.default_rng(11)
    obs = {
        "delta": jnp.asarray(rng.normal(size=(16, 2)), jnp.float32),
        "time": jnp.asarray(rng.normal(size=(16, 1)), jnp.float32),
    }

    ref = ml.ObservationsEMANormalizer.create(
        decay=0.99, dtype=jnp.float32)
    ours = mlt.ObservationsEMANormalizer.create(
        decay=0.99, dtype=jnp.float32)

    # "Train" the reference normalizer: accumulate a batch of stats.
    state = ref.init_state(obs, vmap=False)
    stats = ref.init_obs_stats(state, vmap=False)
    stats = ref.update_obs_stats(state, stats, 1, obs, vmap=False)
    state = ref.update_state(state, stats, vmap=False)

    migrated = convert_reference_params(jax.device_get(state))
    ref_out = ref.preprocess(state, obs, vmap=False)
    our_out = ours.preprocess(migrated, obs, vmap=False)

    for key in obs:
        np.testing.assert_allclose(
            np.asarray(ref_out[key]), np.asarray(our_out[key]),
            rtol=1e-6, atol=1e-6, err_msg=key)


def test_convert_pre_restructure_local_layout():
    """Checkpoints written by this repo's own pre-restructure LSTM
    (cell/layer_<i> holding the reference's eight per-gate denses) must
    convert to the packed layout too (ADVICE r2: they previously passed
    through unconverted and failed to load)."""
    import numpy as np
    from madrona_learn_tpu.compat.reference_import import (
        convert_reference_params)

    rng = np.random.default_rng(0)
    F, H = 3, 4

    def dense(in_dim, bias):
        d = {"kernel": rng.standard_normal((in_dim, H)).astype(np.float32)}
        if bias:
            d["bias"] = rng.standard_normal(H).astype(np.float32)
        return d

    cell = {}
    for g in "ifgo":
        cell[f"i{g}"] = dense(F, bias=False)
        cell[f"h{g}"] = dense(H, bias=True)
    tree = {"params": {"rnn": {"cell": {"layer_0": cell}}}}

    out = convert_reference_params(tree)
    layer = out["params"]["rnn"]["layer_0"]
    assert layer["input_proj"]["kernel"].shape == (F, 4 * H)
    assert layer["recurrent_kernel"].shape == (H, 4 * H)
    assert layer["bias"].shape == (4 * H,)
    np.testing.assert_array_equal(
        layer["input_proj"]["kernel"][:, :H], cell["ii"]["kernel"])
    np.testing.assert_array_equal(layer["bias"][:H], cell["hi"]["bias"])
