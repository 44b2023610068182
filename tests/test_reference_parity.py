"""Numerical parity against the actually-running reference implementation.

These tests import the reference package from /root/reference/src and run its
advantage/return/zscore math side by side with ours on identical fixed-seed
trajectories (reference: algo_common.py:45-140). This replaces the
parity-by-construction claims in PARITY.md with executed comparisons.

The reference targets an older JAX; the only API it uses that no longer
exists is ``jax.tree_map``, shimmed below to ``jax.tree.map`` (pure alias,
no behavior change). Skipped wholesale if the reference tree is absent.
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REF_SRC = "/root/reference/src"

if not os.path.isdir(REF_SRC):  # pragma: no cover
    pytest.skip("reference tree unavailable", allow_module_level=True)

if not hasattr(jax, "tree_map"):
    jax.tree_map = jax.tree.map

sys.path.insert(0, REF_SRC)

from madrona_learn.algo_common import (  # noqa: E402
    compute_advantages as ref_compute_advantages,
    compute_returns as ref_compute_returns,
    zscore_data as ref_zscore_data,
)

from madrona_learn_tpu.ops.gae import (  # noqa: E402
    compute_advantages,
    compute_returns,
    zscore_data,
)

GAMMA = 0.99
LAMBDA = 0.95


def _fake_trajectories(seed, C=3, TC=5, P=2, B=8):
    rng = np.random.default_rng(seed)
    shape = (C, TC, P, B, 1)
    rewards = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    values = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    dones = jnp.asarray(rng.random(shape) < 0.1)
    bootstrap = jnp.asarray(
        rng.standard_normal((P, B, 1)), jnp.float32)
    return rewards, values, dones, bootstrap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_bitwise_matches_reference(seed):
    rewards, values, dones, bootstrap = _fake_trajectories(seed)
    cfg = SimpleNamespace(gamma=GAMMA, gae_lambda=LAMBDA)

    ref = jax.jit(lambda r, v, d, b: ref_compute_advantages(cfg, r, v, d, b))(
        rewards, values, dones, bootstrap)
    ours = jax.jit(
        lambda r, v, d, b: compute_advantages(GAMMA, LAMBDA, r, v, d, b))(
            rewards, values, dones, bootstrap)

    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ours))


@pytest.mark.parametrize("seed", [0, 1])
def test_returns_bitwise_matches_reference(seed):
    rewards, _, dones, bootstrap = _fake_trajectories(seed, C=2, TC=7)
    cfg = SimpleNamespace(gamma=GAMMA)

    ref = jax.jit(lambda r, d, b: ref_compute_returns(cfg, r, d, b))(
        rewards, dones, bootstrap)
    ours = jax.jit(lambda r, d, b: compute_returns(GAMMA, r, d, b))(
        rewards, dones, bootstrap)

    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ours))


def test_zscore_matches_reference():
    rng = np.random.default_rng(7)
    data = jnp.asarray(rng.standard_normal((64, 5)), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(ref_zscore_data(data)), np.asarray(zscore_data(data)))


def test_gae_pallas_kernel_matches_reference():
    """The GAE scan that replaced the Pallas kernel, at the kernel test's
    two-chunk shape, against the reference's fori_loop."""
    from madrona_learn_tpu.ops.gae import compute_advantages

    rewards, values, dones, bootstrap = _fake_trajectories(5, C=2, TC=8,
                                                           P=1, B=16)
    cfg = SimpleNamespace(gamma=GAMMA, gae_lambda=LAMBDA)
    ref = ref_compute_advantages(cfg, rewards, values, dones, bootstrap)
    ours = compute_advantages(
        GAMMA, LAMBDA, rewards, values, dones, bootstrap)
    np.testing.assert_allclose(
        np.asarray(ref), np.asarray(ours), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# PBT population statistics (reference: pbt.py:273-471)
#
# Our pbt_update_elo / pbt_update_fitness are vectorized segment reductions
# (one masked [matches, policies] reduction) where the reference vmaps over
# policies and lax.cond's over every match. These tests drive BOTH
# implementations with identical synthetic match results and require the
# resulting Elo tables / fitness EMAs to agree, proving the redesign is
# semantically faithful where the cull/explore decisions that consume these
# statistics actually live.
# ---------------------------------------------------------------------------

from madrona_learn.pbt import (  # noqa: E402
    pbt_update_elo as ref_pbt_update_elo,
    pbt_update_fitness as ref_pbt_update_fitness,
)
from madrona_learn.train_state import (  # noqa: E402
    MovingEpisodeScore as RefMovingEpisodeScore,
    PolicyState as RefPolicyState,
)

from madrona_learn_tpu.pbt import (  # noqa: E402
    pbt_update_elo,
    pbt_update_fitness,
)
from madrona_learn_tpu.train_state import (  # noqa: E402
    MovingEpisodeScore,
    PolicyState,
)


def _mm_cfg(num_matches, num_teams, team_size, num_policies,
            custom_policy_ids=()):
    # Both implementations read only these attributes in the update fns.
    return SimpleNamespace(
        num_total_matches=num_matches,
        num_teams=num_teams,
        team_size=team_size,
        total_num_policies=num_policies,
        custom_policy_ids=tuple(custom_policy_ids),
    )


def _elo_inputs(seed, num_matches, num_teams, team_size, num_policies,
                extra_ids=()):
    rng = np.random.default_rng(seed)
    ids = list(range(num_policies)) + list(extra_ids)
    per_match = rng.choice(ids, size=(num_matches, num_teams))
    assignments = jnp.asarray(
        np.repeat(per_match, team_size, axis=1).reshape(-1), jnp.int32)
    dones = jnp.asarray(
        rng.random((num_matches * num_teams * team_size, 1)) < 0.7)
    episode_results = jnp.asarray(
        rng.random((num_matches, 2)), jnp.float32)
    policy_elos = jnp.asarray(
        1500.0 + 120.0 * rng.standard_normal(num_policies), jnp.float32)
    return assignments, dones, episode_results, policy_elos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pbt_update_elo_matches_reference(seed):
    P, M, T = 6, 40, 2
    assignments, dones, episode_results, elos = _elo_inputs(seed, M, 2, T, P)
    scores_fn = lambda er: (er[0], er[1])  # noqa: E731
    mm = _mm_cfg(M, 2, T, P)

    ref = ref_pbt_update_elo(
        scores_fn, assignments, dones, episode_results, elos, mm)
    ours = pbt_update_elo(
        scores_fn, assignments, dones, episode_results, elos, mm)

    np.testing.assert_allclose(
        np.asarray(ref), np.asarray(ours), rtol=0, atol=1e-4)


def test_pbt_update_elo_custom_ids_matches_reference():
    """Matches involving custom (scripted) policy ids: both implementations
    must move only real table rows, using the same clamped-gather semantics
    for the out-of-table opponent Elo (reference pbt.py:264-271)."""
    P, M, T = 4, 24, 1
    custom = (97, 103)
    assignments, dones, episode_results, elos = _elo_inputs(
        11, M, 2, T, P, extra_ids=custom)
    scores_fn = lambda er: (er[0], er[1])  # noqa: E731
    mm = _mm_cfg(M, 2, T, P, custom_policy_ids=custom)

    ref = ref_pbt_update_elo(
        scores_fn, assignments, dones, episode_results, elos, mm)
    ours = pbt_update_elo(
        scores_fn, assignments, dones, episode_results, elos, mm)

    np.testing.assert_allclose(
        np.asarray(ref), np.asarray(ours), rtol=0, atol=1e-4)


def _policy_state(cls, score_cls, scores_fn, mean, var, N):
    return cls(
        apply_fn=None,
        rnn_reset_fn=None,
        params={},
        batch_stats={},
        obs_preprocess=None,
        obs_preprocess_state={},
        reward_hyper_params=None,
        get_episode_scores_fn=scores_fn,
        episode_score=score_cls(
            mean=jnp.asarray(mean, jnp.float32),
            var=jnp.asarray(var, jnp.float32),
            N=jnp.asarray(N, jnp.int32)),
        mmr=None,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pbt_update_fitness_matches_reference(seed):
    """Decay-weighted Chan merge of per-update episode scores: per-policy
    mean/var/N must agree between the reference's per-policy scan and our
    one-hot segment reduction, including policies with 0 or 1 finished
    episodes this update (reference pbt.py:382-471)."""
    P, M, T = 5, 64, 2
    rng = np.random.default_rng(seed)

    # Policy P-1 never finishes an episode -> its stats must not move.
    per_match = rng.integers(0, P - 1, size=(M,))
    per_match[0] = P - 2
    assignments = jnp.asarray(
        np.repeat(per_match, T).reshape(-1), jnp.int32)
    dones_m = rng.random(M) < 0.6
    dones = jnp.asarray(np.repeat(dones_m, T).reshape(-1))
    episode_results = jnp.asarray(rng.random(M), jnp.float32)
    scores_fn = lambda er: er  # noqa: E731

    mean0 = rng.standard_normal(P)
    var0 = rng.random(P) + 0.1
    N0 = np.asarray([0, 5, 1, 1000, 0], np.int64)[:P]
    mm = _mm_cfg(M, 1, T, P)

    ref_ps = _policy_state(RefPolicyState, RefMovingEpisodeScore,
                           scores_fn, mean0, var0, N0)
    our_ps = _policy_state(PolicyState, MovingEpisodeScore,
                           scores_fn, mean0, var0, N0)

    ref_out = ref_pbt_update_fitness(
        assignments, ref_ps, dones, episode_results, mm).episode_score
    our_out = pbt_update_fitness(
        assignments, our_ps, dones, episode_results, mm).episode_score

    np.testing.assert_allclose(np.asarray(ref_out.mean),
                               np.asarray(our_out.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref_out.var),
                               np.asarray(our_out.var), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ref_out.N),
                                  np.asarray(our_out.N))
