"""Population-based training: matchmaking, fitness, and evolution.

Capability parity with the reference PBT layer (reference: pbt.py:21-722):

- ``PBTMatchmakeConfig``: derives self/cross/past/static-play batch slices and
  match counts from the portions, asserting divisibility.
- matchmaking: block init for train policies, random opponents for cross/past
  play, per-step rerolls of opponents whose episodes finished.
- fitness: Elo from pairwise episode results (K=1 incremental), or an EMA
  episode-score estimate with a weighted Chan variance update.
- evolution: hyperparameter explore (resample in linear/log space or
  perturb), cull (bottom-k overwritten by mutated top-k), and past-policy
  snapshots, all gated by an expected-winrate / Welch-t overwrite check.

Device notes: every evolution op is expressed as gathers/scatters over the
leading policy axis of the stacked policy/train-state pytrees. Under a mesh
with the population sharded on the ``policy`` axis, XLA lowers these to
collective permutes/all-gathers — no host round trip, matching the
"exploit/explore exchanges via collective permutes" design goal.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
from jax import lax, random

from .config import ParamExplore, TrainConfig


@dataclass(frozen=True)
class PBTMatchmakeConfig:
    num_current_policies: int
    num_past_policies: int
    total_num_policies: int
    num_teams: int
    team_size: int

    self_play_portion: float
    cross_play_portion: float
    past_play_portion: float
    static_play_portion: float

    self_play_batch_size: int
    cross_play_batch_size: int
    past_play_batch_size: int
    static_play_batch_size: int

    num_cross_play_matches: int
    num_past_play_matches: int
    num_static_play_matches: int
    num_total_matches: int

    complex_matchmaking: bool
    custom_policy_ids: List[int]

    # >1: shard-major layout — the sim batch is D contiguous blocks, each
    # with its own proportional self|cross|past|static sub-slices, so every
    # policy draws equal train agents from every data shard and the
    # sim->train emission gather never crosses a shard boundary (the
    # collect-phase analog of ops/reorder.py's shard-local chunk layout).
    # The batch sizes / match counts above stay GLOBAL; per-shard consumers
    # use ``shard_view()``. 1 reproduces the reference's flat layout.
    num_data_shards: int = 1

    @staticmethod
    def setup(
        num_current_policies: int,
        num_past_policies: int,
        num_teams: int,
        team_size: int,
        sim_batch_size: int,
        self_play_portion: float,
        cross_play_portion: float,
        past_play_portion: float,
        static_play_portion: float,
        custom_policy_ids: List[int] = (),
        num_data_shards: int = 1,
    ):
        total = (self_play_portion + cross_play_portion + past_play_portion +
                 static_play_portion)
        assert abs(total - 1.0) < 1e-9, "matchmaking portions must sum to 1"

        self_bs = int(sim_batch_size * self_play_portion)
        cross_bs = int(sim_batch_size * cross_play_portion)
        past_bs = int(sim_batch_size * past_play_portion)
        static_bs = int(sim_batch_size * static_play_portion)
        assert self_bs + cross_bs + past_bs + static_bs == sim_batch_size

        # Shard-major layout: every play-mode slice must split evenly into
        # D per-shard sub-slices, and each sub-slice must satisfy the same
        # structural constraints the D=1 layout does (checked below on the
        # per-shard sizes; D=1 degenerates to the global checks).
        D = num_data_shards
        assert D >= 1
        assert self_bs % D == 0 and cross_bs % D == 0, (
            "play-mode batch sizes must divide num_data_shards")
        assert past_bs % D == 0 and static_bs % D == 0, (
            "play-mode batch sizes must divide num_data_shards")

        agents_per_world = num_teams * team_size
        assert (cross_bs // D) % agents_per_world == 0
        assert (past_bs // D) % agents_per_world == 0
        assert (static_bs // D) % agents_per_world == 0

        num_cross = cross_bs // agents_per_world
        num_past = past_bs // agents_per_world
        num_static = static_bs // agents_per_world
        num_total = sim_batch_size // agents_per_world

        assert (num_cross // D) % num_current_policies == 0
        assert (num_past // D) % num_current_policies == 0
        if self_bs > 0:
            assert (self_bs // D) % num_current_policies == 0

        return PBTMatchmakeConfig(
            num_current_policies=num_current_policies,
            num_past_policies=num_past_policies,
            total_num_policies=num_current_policies + num_past_policies,
            num_teams=num_teams,
            team_size=team_size,
            self_play_portion=self_play_portion,
            cross_play_portion=cross_play_portion,
            past_play_portion=past_play_portion,
            static_play_portion=static_play_portion,
            self_play_batch_size=self_bs,
            cross_play_batch_size=cross_bs,
            past_play_batch_size=past_bs,
            static_play_batch_size=static_bs,
            num_cross_play_matches=num_cross,
            num_past_play_matches=num_past,
            num_static_play_matches=num_static,
            num_total_matches=num_total,
            complex_matchmaking=self_play_portion != 1.0,
            custom_policy_ids=tuple(custom_policy_ids),
            num_data_shards=num_data_shards,
        )

    @staticmethod
    def shardable(
        num_current_policies: int,
        num_teams: int,
        team_size: int,
        sim_batch_size: int,
        self_play_portion: float,
        cross_play_portion: float,
        past_play_portion: float,
        static_play_portion: float,
        num_data_shards: int,
    ) -> bool:
        """Whether the shard-major layout's divisibility holds at D shards."""
        D = num_data_shards
        if D <= 1 or sim_batch_size % D != 0:
            return D == 1
        apw = num_teams * team_size
        sizes = [int(sim_batch_size * p) for p in (
            self_play_portion, cross_play_portion, past_play_portion,
            static_play_portion)]
        if any(s % D for s in sizes):
            return False
        self_l, cross_l, past_l, static_l = (s // D for s in sizes)
        if cross_l % apw or past_l % apw or static_l % apw:
            return False
        if self_l % num_current_policies:
            return False
        return ((cross_l // apw) % num_current_policies == 0
                and (past_l // apw) % num_current_policies == 0)

    def shard_view(self) -> "PBTMatchmakeConfig":
        """The per-shard sub-config of a shard-major layout: one contiguous
        ``sim_batch_size / D`` block, num_data_shards=1. All per-shard
        structure (slice bounds, match counts) comes from this view."""
        D = self.num_data_shards
        if D == 1:
            return self
        return dataclasses.replace(
            self,
            self_play_batch_size=self.self_play_batch_size // D,
            cross_play_batch_size=self.cross_play_batch_size // D,
            past_play_batch_size=self.past_play_batch_size // D,
            static_play_batch_size=self.static_play_batch_size // D,
            num_cross_play_matches=self.num_cross_play_matches // D,
            num_past_play_matches=self.num_past_play_matches // D,
            num_static_play_matches=self.num_static_play_matches // D,
            num_total_matches=self.num_total_matches // D,
            num_data_shards=1,
        )


# ---------------------------------------------------------------------------
# Matchmaking
# ---------------------------------------------------------------------------

def pbt_init_matchmaking(
    assign_rnd,
    mm_cfg: PBTMatchmakeConfig,
    static_play_assignments: Optional[jax.Array],
):
    """Build the initial [sim_batch_size] policy-assignment vector.

    Layout (contiguous slices): self-play | cross-play | past-play | static.
    Team 0 of every cross/past match is a train policy (block-assigned);
    other teams get random opponents (cross: a different train policy; past:
    a past policy).

    With ``num_data_shards > 1`` the whole layout repeats per shard block
    (independent opponent draws per shard): the batch is D contiguous
    blocks of ``self|cross|past|static`` sub-slices, so every data shard
    carries every play mode and every policy's train agents.
    """
    if mm_cfg.num_data_shards > 1:
        D = mm_cfg.num_data_shards
        shard_cfg = mm_cfg.shard_view()
        keys = random.split(assign_rnd, D)
        if static_play_assignments is None:
            per_shard = jax.vmap(
                lambda k: pbt_init_matchmaking(k, shard_cfg, None))(keys)
        else:
            static_sh = static_play_assignments.reshape(D, -1)
            per_shard = jax.vmap(
                lambda k, s: pbt_init_matchmaking(k, shard_cfg, s))(
                    keys, static_sh)
        return per_shard.reshape(-1)

    def block_assign(batch_size):
        return jnp.repeat(
            jnp.arange(mm_cfg.num_current_policies),
            batch_size // mm_cfg.num_current_policies)

    parts = []

    if mm_cfg.self_play_batch_size > 0:
        parts.append(block_assign(mm_cfg.self_play_batch_size))

    if mm_cfg.cross_play_batch_size > 0:
        assign_rnd, cross_rnd = random.split(assign_rnd)
        base = block_assign(mm_cfg.cross_play_batch_size).reshape(
            mm_cfg.num_cross_play_matches, mm_cfg.num_teams, mm_cfg.team_size)
        opponents = _sample_cross_opponents(
            cross_rnd, base[:, 0, 0], mm_cfg,
            (mm_cfg.num_cross_play_matches, mm_cfg.num_teams - 1))
        base = base.at[:, 1:, :].set(opponents[..., None])
        parts.append(base.reshape(-1))

    if mm_cfg.past_play_batch_size > 0:
        assign_rnd, past_rnd = random.split(assign_rnd)
        base = block_assign(mm_cfg.past_play_batch_size).reshape(
            mm_cfg.num_past_play_matches, mm_cfg.num_teams, mm_cfg.team_size)
        opponents = random.randint(
            past_rnd, (mm_cfg.num_past_play_matches, mm_cfg.num_teams - 1),
            mm_cfg.num_current_policies,
            mm_cfg.num_current_policies + mm_cfg.num_past_policies)
        base = base.at[:, 1:, :].set(opponents[..., None])
        parts.append(base.reshape(-1))

    if mm_cfg.static_play_batch_size > 0:
        assert static_play_assignments is not None
        parts.append(static_play_assignments.reshape(-1))

    return jnp.concatenate(parts, axis=0)


def _sample_cross_opponents(rnd, team0_policy, mm_cfg, shape):
    """Uniform over train policies excluding each match's own team-0 policy."""
    draws = random.randint(rnd, shape, 0, mm_cfg.num_current_policies - 1)
    return jnp.where(
        draws >= team0_policy.reshape(-1, *([1] * (len(shape) - 1))),
        draws + 1, draws)


def pbt_update_matchmaking(assignments, policy_states, dones, episode_results,
                           assign_rnd, mm_cfg: PBTMatchmakeConfig):
    """Per-step reroll: opponents of finished episodes get fresh matchups.

    Shard-major layouts (``num_data_shards > 1``) reroll each shard block
    independently with its own key — slice offsets stay shard-local.
    """
    if mm_cfg.num_data_shards > 1:
        D = mm_cfg.num_data_shards
        shard_cfg = mm_cfg.shard_view()
        keys = random.split(assign_rnd, D + 1)
        new_rnd = keys[0]
        a_sh = assignments.reshape(D, -1)
        d_sh = dones.reshape(D, dones.shape[0] // D, *dones.shape[1:])

        def reroll_one(a, d, k):
            new_a, _ = pbt_update_matchmaking(
                a, policy_states, d, episode_results, k, shard_cfg)
            return new_a

        new_a = jax.vmap(reroll_one)(a_sh, d_sh, keys[1:])
        return new_a.reshape(assignments.shape), new_rnd

    cross_start = mm_cfg.self_play_batch_size
    cross_end = cross_start + mm_cfg.cross_play_batch_size
    past_end = cross_end + mm_cfg.past_play_batch_size

    if mm_cfg.cross_play_batch_size > 0:
        assign_rnd, cross_rnd = random.split(assign_rnd)
        sl = slice(cross_start, cross_end)
        cur = assignments[sl].reshape(
            mm_cfg.num_cross_play_matches, mm_cfg.num_teams, mm_cfg.team_size)
        cur_dones = dones[sl].reshape(cur.shape)
        fresh = _sample_cross_opponents(
            cross_rnd, cur[:, 0, 0], mm_cfg,
            (mm_cfg.num_cross_play_matches, mm_cfg.num_teams - 1))
        new_opp = jnp.where(
            cur_dones[:, 1:, :], fresh[:, :, None], cur[:, 1:, :])
        assignments = assignments.at[sl].set(
            cur.at[:, 1:, :].set(new_opp).reshape(-1))

    if mm_cfg.past_play_batch_size > 0:
        assign_rnd, past_rnd = random.split(assign_rnd)
        sl = slice(cross_end, past_end)
        cur = assignments[sl].reshape(
            mm_cfg.num_past_play_matches, mm_cfg.num_teams, mm_cfg.team_size)
        cur_dones = dones[sl].reshape(cur.shape)
        fresh = random.randint(
            past_rnd, (mm_cfg.num_past_play_matches, mm_cfg.num_teams - 1),
            mm_cfg.num_current_policies,
            mm_cfg.num_current_policies + mm_cfg.num_past_policies)
        new_opp = jnp.where(
            cur_dones[:, 1:, :], fresh[:, :, None], cur[:, 1:, :])
        assignments = assignments.at[sl].set(
            cur.at[:, 1:, :].set(new_opp).reshape(-1))

    return assignments, assign_rnd


# ---------------------------------------------------------------------------
# Fitness: Elo + EMA episode score
# ---------------------------------------------------------------------------

def elo_expected_result(my_elo, opponent_elo):
    return 1.0 / (1.0 + 10.0 ** ((opponent_elo - my_elo) / 400.0))


def _convert_custom_policy_ids(assignments, mm_cfg):
    """Remap caller-defined custom policy ids to slots past the Elo table.

    Vectorized over the static tuple of custom ids: one equality mask per
    call instead of a rewrite chain.
    """
    if not mm_cfg.custom_policy_ids:
        return assignments
    custom = jnp.asarray(mm_cfg.custom_policy_ids, assignments.dtype)
    eq = assignments[..., None] == custom  # [..., num_custom]
    remap = (jnp.argmax(eq, axis=-1) + mm_cfg.total_num_policies).astype(
        assignments.dtype)
    return jnp.where(jnp.any(eq, axis=-1), remap, assignments)


def pbt_update_elo(get_episode_scores_fn, assignments, dones, episode_results,
                   policy_elos, mm_cfg: PBTMatchmakeConfig):
    """Incremental Elo (K=1) from per-world episode results.

    Two-team only (capability parity: reference pbt.py:273-343). On-device
    formulation: each finished match's (score - expected_score) is computed
    once for both sides, then segment-reduced into per-policy deltas through
    a one-hot select-reduce over the [matches, policies] mask — a single
    batched reduction instead of policies x matches conditionals. Matches
    where both teams run the same policy are skipped.
    """
    assert mm_cfg.num_teams == 2
    num_policies = policy_elos.shape[0]

    assignments = _convert_custom_policy_ids(assignments, mm_cfg)
    assignments = assignments.reshape(
        mm_cfg.num_total_matches, mm_cfg.num_teams, mm_cfg.team_size)
    dones = dones.reshape(
        mm_cfg.num_total_matches, mm_cfg.num_teams, mm_cfg.team_size, -1)

    a = assignments[:, 0, 0]
    b = assignments[:, 1, 0]
    valid = jnp.logical_and(dones[:, 0, 0, 0], a != b)

    a_scores, b_scores = jax.vmap(get_episode_scores_fn)(episode_results)
    # Out-of-table ids (converted custom policies) clamp in the gather; the
    # one-hot mask below zeroes their contribution to the update, so only
    # real table rows ever move.
    elo_a = policy_elos[a]
    elo_b = policy_elos[b]
    diff_a = jnp.where(
        valid, a_scores - elo_expected_result(elo_a, elo_b), 0.0)
    diff_b = jnp.where(
        valid, b_scores - elo_expected_result(elo_b, elo_a), 0.0)

    pids = jnp.arange(num_policies)
    contrib = (jnp.where(a[:, None] == pids[None, :], diff_a[:, None], 0.0)
               + jnp.where(b[:, None] == pids[None, :], diff_b[:, None], 0.0))
    K = 1.0
    return policy_elos + K * jnp.sum(contrib, axis=0)


def pbt_update_fitness(assignments, policy_states, dones, episode_results,
                       mm_cfg: PBTMatchmakeConfig):
    """EMA episode-score fitness for non-competitive populations.

    Single-team only (capability parity: reference pbt.py:382-471, the
    decayed weighted Chan mean/var merge). On-device formulation: episode
    scores are computed once, per-policy count/mean/var come from masked
    one-hot reductions (two-pass variance), and the decay-weighted merge
    runs elementwise over the whole policy axis at once.
    """
    assert mm_cfg.num_teams == 1
    assert policy_states.mmr is None and policy_states.episode_score is not None

    cur = policy_states.episode_score
    num_policies = cur.mean.shape[0]

    assignments = assignments.reshape(
        mm_cfg.num_total_matches, mm_cfg.team_size)[:, 0]
    dones = dones.reshape(mm_cfg.num_total_matches, mm_cfg.team_size)[:, 0]

    scores = jax.vmap(policy_states.get_episode_scores_fn)(
        episode_results).astype(jnp.float32)

    onehot = jnp.logical_and(
        assignments[:, None] == jnp.arange(num_policies)[None, :],
        dones[:, None])                                        # [M, P]
    x_n = jnp.sum(onehot, axis=0, dtype=cur.N.dtype)           # [P]
    x_nf = x_n.astype(jnp.float32)
    x_mean = (jnp.sum(jnp.where(onehot, scores[:, None], 0.0), axis=0)
              / jnp.maximum(x_nf, 1.0))
    sq_dev = jnp.square(scores[:, None] - x_mean[None, :])
    x_ssd = jnp.sum(jnp.where(onehot, sq_dev, 0.0), axis=0)
    x_var = jnp.where(x_n > 1, x_ssd / jnp.maximum(x_nf - 1.0, 1.0), 0.0)

    ema_decay = 0.9999
    mean_delta = x_mean - cur.mean
    cur_weight = jnp.expm1(x_nf * jnp.log(ema_decay)) + 1.0
    x_weight = 1.0 - cur_weight

    n_max = jnp.iinfo(cur.N.dtype).max
    new_n = jnp.where(x_n > n_max - cur.N, n_max, cur.N + x_n)

    cross = jnp.where(
        cur.N > 0,
        cur.N.astype(jnp.float32)
        / jnp.maximum((new_n - 1).astype(jnp.float32), 1.0)
        * (cur_weight * x_weight) * jnp.square(mean_delta),
        0.0)
    new_mean = cur_weight * cur.mean + x_weight * x_mean
    new_var = cur_weight * cur.var + x_weight * x_var + cross

    has_data = x_n > 0
    new_scores = cur.replace(
        mean=jnp.where(has_data, new_mean, cur.mean),
        var=jnp.where(has_data, new_var, cur.var),
        N=jnp.where(has_data, new_n, cur.N),
    )
    return policy_states.update(episode_score=new_scores)


# ---------------------------------------------------------------------------
# Hyperparameter exploration
# ---------------------------------------------------------------------------

def explore_param(rnd, param, param_explore: ParamExplore, resample_chance):
    """Resample (uniform in the configured space) or perturb one scalar."""
    lo = param_explore.base * param_explore.min_scale
    hi = param_explore.base * param_explore.max_scale

    def resample(param_rnd, param):
        if param_explore.log10_scale:
            lo_s, hi_s = math.log10(lo), math.log10(hi)
        elif param_explore.ln_scale:
            lo_s, hi_s = math.log(lo), math.log(hi)
        else:
            lo_s, hi_s = lo, hi
        sampled = random.uniform(
            param_rnd, (), jnp.float32, minval=lo_s, maxval=hi_s)
        if param_explore.log10_scale:
            sampled = 10.0 ** sampled
        elif param_explore.ln_scale:
            sampled = jnp.exp(sampled)
        return sampled

    def perturb(param_rnd, param):
        perturbed = param * random.uniform(
            param_rnd, (), jnp.float32,
            minval=param_explore.perturb_rnd_min,
            maxval=param_explore.perturb_rnd_max)
        if param_explore.clip_perturb:
            perturbed = jnp.clip(perturbed, lo, hi)
        return perturbed

    resample_rnd, param_rnd = random.split(rnd)
    should_resample = random.uniform(
        resample_rnd, (), jnp.float32) < resample_chance
    return lax.cond(should_resample, resample, perturb, param_rnd, param)


def pbt_explore_hyperparams(cfg: TrainConfig, explore_rng, policy_state,
                            train_state, resample_chance):
    """Mutate reward hyperparams + algo hyperparams for one policy."""
    lr_rnd, algo_rnd, reward_rnd = random.split(explore_rng, 3)

    if policy_state.reward_hyper_params is not None:
        params = policy_state.reward_hyper_params
        assert params.ndim == 1
        rnds = random.split(reward_rnd, params.shape[0])
        for i, (name, spec) in enumerate(
                cfg.pbt.reward_hyper_params_explore.items()):
            params = params.at[i].set(
                explore_param(rnds[i], params[i], spec, resample_chance))
        policy_state = policy_state.update(reward_hyper_params=params)

    hp = train_state.hyper_params
    if isinstance(cfg.lr, ParamExplore):
        hp = hp.replace(
            lr=explore_param(lr_rnd, hp.lr, cfg.lr, resample_chance))

    # Delegate algorithm-specific hyperparams (e.g. PPO's entropy coef) to the
    # algo config so PBT isn't PPO-specific.
    explore_algo = getattr(cfg.algo, "explore_hyperparams", None)
    if explore_algo is not None:
        hp = explore_algo(algo_rnd, hp, resample_chance)

    train_state = train_state.update(hyper_params=hp)
    return policy_state, train_state


# ---------------------------------------------------------------------------
# Population evolution
# ---------------------------------------------------------------------------

def _check_overwrite(cfg: TrainConfig, policy_states, src_idx, dst_idx):
    """Should src's weights overwrite dst's?

    Competitive populations compare Elo expected winrate against the
    threshold; fitness populations run a one-sided Welch test (p < 0.2).
    """
    if policy_states.mmr is not None:
        src_elo = policy_states.mmr.elo[src_idx]
        dst_elo = policy_states.mmr.elo[dst_idx]
        return (elo_expected_result(src_elo, dst_elo)
                >= cfg.pbt.policy_overwrite_threshold)

    scores = policy_states.episode_score
    src_s2 = scores.var[src_idx] / scores.N[src_idx].astype(jnp.float32)
    dst_s2 = scores.var[dst_idx] / scores.N[dst_idx].astype(jnp.float32)
    t = (scores.mean[src_idx] - scores.mean[dst_idx]) / jnp.sqrt(
        src_s2 + dst_s2)
    p = 1 - jax.scipy.stats.norm.cdf(t)
    return p < 0.20


def _get_fitness_scores(policy_states):
    if policy_states.mmr is not None:
        return policy_states.mmr.elo
    return policy_states.episode_score.mean


def pbt_cull_update(cfg: TrainConfig, train_state_mgr, num_cull_policies: int):
    """Overwrite the bottom-k train policies with mutated top-k copies.

    The destination keeps its own update PRNG key; hyperparams are mutated
    with resample_chance 0.2. Under a policy-sharded mesh the tree-wide
    ``x.at[bottom].set(x[top])`` writes lower to cross-shard permutes.
    """
    policy_states = train_state_mgr.policy_states
    train_states = train_state_mgr.train_states
    pbt_rng = train_state_mgr.pbt_rng

    assert 2 * num_cull_policies <= cfg.pbt.num_train_policies

    fitness = _get_fitness_scores(policy_states)
    sort_idxs = jnp.argsort(fitness[0:cfg.pbt.num_train_policies])
    bottom_idxs = sort_idxs[:num_cull_policies]
    top_idxs = sort_idxs[-num_cull_policies:]

    @partial(jax.vmap, in_axes=(None, None, 0, 0, 0))
    def cull_one(policy_states, train_states, mutate_rng, dst_idx, src_idx):
        def overwrite():
            src_policy = jax.tree.map(lambda x: x[src_idx], policy_states)
            src_train = jax.tree.map(lambda x: x[src_idx], train_states)
            src_train = src_train.update(
                update_prng_key=train_states.update_prng_key[dst_idx])
            return pbt_explore_hyperparams(
                cfg, mutate_rng, src_policy, src_train, 0.2)

        def keep():
            return (jax.tree.map(lambda x: x[dst_idx], policy_states),
                    jax.tree.map(lambda x: x[dst_idx], train_states))

        should = _check_overwrite(cfg, policy_states, src_idx, dst_idx)
        return lax.cond(should, overwrite, keep)

    pbt_rng, mutate_base = random.split(pbt_rng)
    new_policy, new_train = cull_one(
        policy_states, train_states,
        random.split(mutate_base, num_cull_policies),
        bottom_idxs, top_idxs)

    write = lambda full, new: full.at[bottom_idxs].set(new)
    return train_state_mgr.replace(
        policy_states=jax.tree.map(write, policy_states, new_policy),
        train_states=jax.tree.map(write, train_states, new_train),
        pbt_rng=pbt_rng,
    )


def pbt_past_update(cfg: TrainConfig, train_state_mgr):
    """Snapshot a random train policy into the weakest past slot."""
    if cfg.pbt.num_past_policies == 0:
        return train_state_mgr

    policy_states = train_state_mgr.policy_states
    pbt_rng, src_rng = random.split(train_state_mgr.pbt_rng)

    fitness = _get_fitness_scores(policy_states)
    src_idx = random.randint(src_rng, (), 0, cfg.pbt.num_train_policies)
    dst_idx = (jnp.argmin(fitness[cfg.pbt.num_train_policies:])
               + cfg.pbt.num_train_policies)

    def overwrite(states):
        return jax.tree.map(lambda x: x.at[dst_idx].set(x[src_idx]), states)

    should = _check_overwrite(cfg, policy_states, src_idx, dst_idx)
    policy_states = lax.cond(
        should, overwrite, lambda s: s, policy_states)

    return train_state_mgr.replace(
        policy_states=policy_states, pbt_rng=pbt_rng)
