"""Semantic Elo test: in the bidding duel, policies that bid higher must end
the all-pairs tournament with higher Elo, and cull must copy winners over
losers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import madrona_learn_tpu as mlt
from madrona_learn_tpu.pbt import pbt_cull_update

from test_pbt_e2e import NUM_PAST, NUM_TRAIN, build_training_mgr


def bias_policies_by_strength(mgr):
    """Make policy i deterministically prefer bid action i+1 (0..4 scale):
    higher index -> higher bids -> should win duels."""
    params = mgr.state.policy_states.params

    def tweak(path, leaf):
        # Find the actor head's bias: shape [..., 5] on the policy axis.
        if path[-1].key == "bias" and leaf.ndim == 2 and leaf.shape[-1] == 5:
            P = leaf.shape[0]
            new = np.full((P, 5), -10.0, np.float32)
            for i in range(P):
                new[i, min(i + 1, 4)] = 10.0
            return jnp.asarray(new)
        return leaf

    new_params = jax.tree_util.tree_map_with_path(tweak, params)
    return mgr.replace(state=mgr.state.replace(
        policy_states=mgr.state.policy_states.update(params=new_params)))


@pytest.mark.slow
def test_elo_orders_by_strength_and_cull_copies_winner():
    mgr = build_training_mgr(seed=23)
    mgr = bias_policies_by_strength(mgr)

    episode_len = 8
    mgr, _ = jax.jit(lambda m: mlt.eval_elo(
        m, num_eval_steps=4 * episode_len,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32)))(mgr)

    elos = np.asarray(mgr.state.policy_states.mmr.elo)
    train_elos = elos[:NUM_TRAIN]
    # Strictly increasing strength by construction -> Elo must follow for
    # the train policies (0 bids lowest, NUM_TRAIN-1 highest).
    assert train_elos[-1] > train_elos[0], train_elos
    assert np.argmax(train_elos) == NUM_TRAIN - 1, train_elos
    assert np.argmin(train_elos) == np.argmin(train_elos[:NUM_TRAIN])

    # Cull: the weakest train policy must receive the strongest's params.
    weakest = int(np.argmin(train_elos))
    strongest = int(np.argmax(train_elos))

    params_before = jax.device_get(mgr.state.policy_states.params)

    new_state = jax.jit(
        lambda s: pbt_cull_update(mgr.cfg, s, 1))(mgr.state)
    params_after = jax.device_get(new_state.policy_states.params)

    def actor_bias(params, idx):
        leaves = [
            l for p, l in jax.tree_util.tree_flatten_with_path(params)[0]
            if p[-1].key == "bias" and l.ndim == 2 and l.shape[-1] == 5]
        return np.asarray(leaves[0][idx])

    np.testing.assert_array_equal(
        actor_bias(params_after, weakest),
        actor_bias(params_before, strongest))


@pytest.mark.slow
def test_eval_elo_compile_cached_across_calls():
    """Eager eval_elo calls must reuse the compiled tournament: the second
    call may not pay trace+compile time again."""
    import time

    mgr = build_training_mgr(seed=29)
    kwargs = dict(
        num_eval_steps=8,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))

    t0 = time.perf_counter()
    mgr2, deltas = mlt.eval_elo(mgr, **kwargs)
    jax.block_until_ready(deltas)
    first = time.perf_counter() - t0

    t0 = time.perf_counter()
    mgr3, deltas = mlt.eval_elo(mgr2, **kwargs)
    jax.block_until_ready(deltas)
    second = time.perf_counter() - t0

    # Compile dominates the first call by orders of magnitude on this tiny
    # config; 4x is a loose bound robust to CI noise.
    assert second < first / 4, (first, second)
    assert np.isfinite(np.asarray(mgr3.state.policy_states.mmr.elo)).all()


def _np_elo_oracle(get_scores, assignments, dones, episode_results,
                   policy_elos, num_teams, team_size):
    """Slow per-match numpy oracle for the K=1 incremental Elo update."""
    P = policy_elos.shape[0]
    M = assignments.reshape(-1).shape[0] // (num_teams * team_size)
    asn = assignments.reshape(M, num_teams, team_size)
    dn = dones.reshape(M, num_teams, team_size, -1)
    deltas = np.zeros(P, np.float64)
    for m in range(M):
        a, b = int(asn[m, 0, 0]), int(asn[m, 1, 0])
        if not dn[m, 0, 0, 0] or a == b:
            continue
        a_score, b_score = get_scores(episode_results[m])
        ea = policy_elos[min(a, P - 1)]
        eb = policy_elos[min(b, P - 1)]
        exp_a = 1.0 / (1.0 + 10.0 ** ((eb - ea) / 400.0))
        exp_b = 1.0 / (1.0 + 10.0 ** ((ea - eb) / 400.0))
        if a < P:
            deltas[a] += float(a_score) - exp_a
        if b < P:
            deltas[b] += float(b_score) - exp_b
    return policy_elos + deltas


def test_pbt_update_elo_matches_numpy_oracle():
    """Randomized matches vs an independent per-match numpy recomputation,
    including same-policy matches, unfinished episodes, and custom ids."""
    from madrona_learn_tpu.pbt import PBTMatchmakeConfig, pbt_update_elo

    rng = np.random.default_rng(7)
    P, M, team_size = 6, 48, 2
    custom_id = 100
    mm_cfg = PBTMatchmakeConfig.setup(
        num_current_policies=P, num_past_policies=0, num_teams=2,
        team_size=team_size, sim_batch_size=M * 2 * team_size,
        self_play_portion=0.0, cross_play_portion=1.0,
        past_play_portion=0.0, static_play_portion=0.0,
        custom_policy_ids=[custom_id],
    )

    teams = rng.integers(0, P, size=(M, 2))
    # Inject same-policy matches and a custom-id opponent.
    teams[3, 1] = teams[3, 0]
    teams[7, 1] = custom_id
    assignments = np.repeat(teams, team_size, axis=1).reshape(-1)
    match_done = rng.random(M) < 0.7
    dones = np.repeat(match_done, 2 * team_size).reshape(-1, 1)
    episode_results = rng.standard_normal((M, 2)).astype(np.float32)
    policy_elos = (1500 + 30 * rng.standard_normal(P)).astype(np.float32)

    def get_scores(er):
        return er[0], er[1]

    got = jax.jit(
        lambda *a: pbt_update_elo(get_scores, *a, mm_cfg))(
            jnp.asarray(assignments), jnp.asarray(dones),
            jnp.asarray(episode_results), jnp.asarray(policy_elos))

    # Custom ids remap past the table: the oracle treats them as clamped
    # gathers whose own rows never move, matching _convert_custom_policy_ids.
    conv = np.where(assignments == custom_id, P, assignments)
    want = _np_elo_oracle(
        get_scores, conv, dones, episode_results,
        policy_elos.astype(np.float64), 2, team_size)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


def test_pbt_update_fitness_matches_numpy_oracle():
    """Randomized scores vs an independent per-policy Chan/EMA recompute."""
    from madrona_learn_tpu.pbt import PBTMatchmakeConfig, pbt_update_fitness
    from madrona_learn_tpu.train_state import MovingEpisodeScore, PolicyState

    rng = np.random.default_rng(11)
    P, M = 4, 64
    mm_cfg = PBTMatchmakeConfig.setup(
        num_current_policies=P, num_past_policies=0, num_teams=1,
        team_size=1, sim_batch_size=M,
        self_play_portion=1.0, cross_play_portion=0.0,
        past_play_portion=0.0, static_play_portion=0.0)

    assignments = rng.integers(0, P, size=M)
    assignments[assignments == 3] = 2  # leave policy 3 with zero episodes
    dones = rng.random(M) < 0.6
    scores = rng.standard_normal(M).astype(np.float32) * 3 + 1

    cur = MovingEpisodeScore(
        mean=jnp.asarray(rng.standard_normal(P).astype(np.float32)),
        var=jnp.asarray(rng.random(P).astype(np.float32)),
        N=jnp.asarray([0, 5, 100, 2], jnp.int32))

    policy_states = PolicyState(
        apply_fn=None, rnn_reset_fn=None, params={}, batch_stats={},
        obs_preprocess=None, obs_preprocess_state={},
        reward_hyper_params=None,
        get_episode_scores_fn=lambda er: er,
        episode_score=cur, mmr=None)

    updated = jax.jit(lambda a, d, er: pbt_update_fitness(
        a, policy_states, d, er, mm_cfg))(
            jnp.asarray(assignments), jnp.asarray(dones),
            jnp.asarray(scores))
    got = updated.episode_score

    decay = 0.9999
    for p in range(P):
        mask = (assignments == p) & dones
        n = int(mask.sum())
        cur_mean = float(cur.mean[p])
        cur_var = float(cur.var[p])
        cur_n = int(cur.N[p])
        if n == 0:
            np.testing.assert_allclose(float(got.mean[p]), cur_mean)
            np.testing.assert_allclose(float(got.var[p]), cur_var)
            assert int(got.N[p]) == cur_n
            continue
        x = scores[mask].astype(np.float64)
        x_mean = x.mean()
        x_var = x.var(ddof=1) if n > 1 else 0.0
        cw = np.expm1(n * np.log(decay)) + 1.0
        xw = 1.0 - cw
        new_n = cur_n + n
        cross = (cur_n / (new_n - 1) * cw * xw * (x_mean - cur_mean) ** 2
                 if cur_n > 0 else 0.0)
        np.testing.assert_allclose(
            float(got.mean[p]), cw * cur_mean + xw * x_mean, rtol=1e-5)
        np.testing.assert_allclose(
            float(got.var[p]), cw * cur_var + xw * x_var + cross, rtol=1e-4)
        assert int(got.N[p]) == new_n


def test_underfilled_tournament_still_ranks_strongest_first():
    """VERDICT r2 item 8: when the sim batch provides fewer match slots
    than all-pairs pairings (6 policies -> 36 pairings vs 32 slots here),
    the warning must state the dropped-pairing count and the pair_offset
    rotation mechanism (no static pair list is truthful — which pairings
    drop depends on the traced per-cycle offset), and the partial
    tournament must still rank a strictly-stronger policy first — the
    dropped pairs only remove head-to-head evidence, and transitivity
    through shared opponents preserves the ordering."""
    import warnings as _warnings

    mgr = build_training_mgr(seed=101)
    mgr = bias_policies_by_strength(mgr)

    with pytest.warns(UserWarning, match="drops 4 pairings") as rec:
        mgr, _ = mlt.eval_elo(
            mgr, num_eval_steps=16,
            eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
            train_sim_ctrl=jnp.zeros((1,), jnp.int32))
    msgs = [str(w.message) for w in rec
            if "drops 4 pairings" in str(w.message)]
    assert msgs and "pair_offset" in msgs[0]  # rotation mechanism named

    elos = np.asarray(mgr.state.policy_states.mmr.elo)
    train_elos = elos[:NUM_TRAIN]
    assert np.argmax(train_elos) == NUM_TRAIN - 1, train_elos
    assert train_elos[-1] > train_elos[0], train_elos


def test_eval_elo_warmup_precompiles_tournament():
    """eval_elo_warmup must land the compiled tournament in the jit cache:
    the first eval_elo call after a blocking warmup may not pay
    trace+compile again (VERDICT r2 item 6 — the first in-loop tournament
    cycle was compile-dominated)."""
    import time

    kwargs = dict(
        num_eval_steps=8,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))

    # Reference cost: cold compile + run on an unwarmed manager.
    mgr_cold = build_training_mgr(seed=43)
    t0 = time.perf_counter()
    _, deltas = mlt.eval_elo(mgr_cold, **kwargs)
    jax.block_until_ready(deltas)
    cold = time.perf_counter() - t0

    mgr = build_training_mgr(seed=44)
    t0 = time.perf_counter()
    mlt.eval_elo_warmup(mgr, block=True, **kwargs)
    warm_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    mgr2, deltas = mlt.eval_elo(mgr, **kwargs)
    jax.block_until_ready(deltas)
    first_call = time.perf_counter() - t0

    # The warmup carried the compile; the first real call must be fast.
    assert first_call < cold / 4, (cold, warm_compile, first_call)
    assert np.isfinite(np.asarray(mgr2.state.policy_states.mmr.elo)).all()

    # The population update is warmed too: un-warmed, its first call pays
    # the compile of the cull/past programs.
    t0 = time.perf_counter()
    mgr_cold2 = mlt.update_population(mgr_cold)
    jax.block_until_ready(mgr_cold2.state.policy_states.mmr.elo)
    cold_evolve = time.perf_counter() - t0

    t0 = time.perf_counter()
    mgr2b = mlt.update_population(mgr2)
    jax.block_until_ready(mgr2b.state.policy_states.mmr.elo)
    warm_evolve = time.perf_counter() - t0
    assert warm_evolve < max(cold_evolve / 4, 0.25), (
        cold_evolve, warm_evolve)

    # Async warmup overlaps compile on a thread and must be joinable.
    mgr3 = build_training_mgr(seed=45)
    thread = mlt.eval_elo_warmup(mgr3, block=False, **kwargs)
    thread.join(timeout=300)
    assert not thread.is_alive()
    t0 = time.perf_counter()
    _, deltas = mlt.eval_elo(mgr3, **kwargs)
    jax.block_until_ready(deltas)
    assert time.perf_counter() - t0 < cold / 4


def test_stop_training_joins_warmup_thread():
    """VERDICT r3 item 7: a clean shutdown must not leave an
    eval_elo_warmup daemon thread alive (possibly mid-XLA-compile) to race
    interpreter teardown — stop_training joins it before returning."""
    kwargs = dict(
        num_eval_steps=8,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))

    mgr = build_training_mgr(seed=46)
    thread = mlt.eval_elo_warmup(mgr, block=False, **kwargs)
    # Immediately stop: the join must cover a thread still compiling.
    mlt.stop_training(mgr)
    assert not thread.is_alive()

    # The warmed program is intact after the join; eval_elo still works.
    mgr2, deltas = mlt.eval_elo(mgr, **kwargs)
    assert np.isfinite(np.asarray(deltas)).all()

    # Registry is drained: a second stop_training is a no-op, and a fresh
    # warmup after stop re-registers (stop/start cycles stay safe).
    mlt.stop_training(mgr)
    thread2 = mlt.eval_elo_warmup(mgr2, block=False, **kwargs)
    mlt.stop_training(mgr2)
    assert not thread2.is_alive()


def test_pair_offset_rotates_underfilled_coverage():
    """Advancing eval_elo's pair_offset must hand the previously-dropped
    pairings match slots on later cycles (coverage sweeps instead of
    always starving the same tail), without retracing the tournament."""
    from madrona_learn_tpu.train import _build_all_pairs_assignments

    num_policies, teams, team_size = 3, 2, 1
    num_pairs = num_policies * num_policies  # 9 pairings
    slots = 4                                # underfilled
    sim_batch = slots * teams * team_size

    def pairs_at(offset):
        with pytest.warns(UserWarning, match="underfilled"):
            a = np.asarray(_build_all_pairs_assignments(
                num_policies, (), sim_batch, teams, team_size,
                pair_offset=offset))
        return set(map(tuple, a.reshape(slots, teams).tolist()))

    covered = set()
    for cycle in range(3):
        covered |= pairs_at(cycle * slots)
    assert len(covered) == min(3 * slots, num_pairs)

    # Traced offset: one compile serves every rotation.
    mgr = build_training_mgr(seed=103)
    kwargs = dict(
        num_eval_steps=8,
        eval_sim_ctrl=jnp.zeros((1,), jnp.int32),
        train_sim_ctrl=jnp.zeros((1,), jnp.int32))
    import time
    with pytest.warns(UserWarning):
        mgr, _ = mlt.eval_elo(mgr, pair_offset=0, **kwargs)
    t0 = time.perf_counter()
    mgr, _ = mlt.eval_elo(mgr, pair_offset=7, **kwargs)
    assert time.perf_counter() - t0 < 5  # cache hit, no retrace
    assert np.isfinite(np.asarray(mgr.state.policy_states.mmr.elo)).all()
