"""Deterministic integer-arithmetic rollout verification with a fake sim +
fake policy.

Port of the reference's centerpiece test strategy (reference:
tests/test_rollouts.py:202-810): the network is an exactly-predictable
integer recurrence whose learnable bias equals the policy index, so actions
encode which policy produced them. A numpy oracle recomputes every agent's
trajectory and everything — actions, values, rewards, rnn states, and
within-episode assignment constancy — is checked bit-exactly, across a sweep
of matchmaking configurations (self/cross/past play, PBT populations).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from madrona_learn_tpu.struct import FrozenDict
from jax import random

from madrona_learn_tpu.envs.fake_sim import (
    FakeActor,
    FakeCritic,
    FakeNet,
    FakeRNN,
    FakeSimConfig,
    make_fake_sim,
)
from madrona_learn_tpu.models import (
    ActorCritic,
    BackboneShared,
    DictActor,
    RecurrentBackboneEncoder,
)
from madrona_learn_tpu.observations import ObservationsPreprocessNoop
from madrona_learn_tpu.rollouts import RolloutConfig, RolloutState, rollout_loop
from madrona_learn_tpu.train_state import PolicyState


def build_fake_policy_states(rollout_cfg):
    """Stacked PolicyStates whose FakeNet bias == policy index."""
    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs, train: obs,
            encoder=RecurrentBackboneEncoder(net=FakeNet(), rnn=FakeRNN()),
        ),
        actor=DictActor(heads={"fake": FakeActor()}),
        critic=FakeCritic(),
    )

    P = rollout_cfg.pbt.total_num_policies
    example_obs = FrozenDict({
        "o": jnp.zeros((1, 1), jnp.int32),
        "c": jnp.zeros((1, 1), jnp.int32),
    })

    def init_one(rnd):
        rnn = actor_critic.init_recurrent_state(1)
        (out, _), variables = actor_critic.init_with_output(
            rnd, random.PRNGKey(0), rnn, example_obs, method="rollout")
        return variables["params"]

    params = jax.vmap(init_one)(random.split(random.PRNGKey(0), P))
    # bias <- policy index
    biases = jnp.arange(P, dtype=jnp.int32)

    def set_bias(p):
        flat, treedef = jax.tree_util.tree_flatten_with_path(p)
        out = {}
        new_leaves = []
        for path, leaf in flat:
            if path[-1].key == "bias":
                new_leaves.append(biases)
            else:
                new_leaves.append(leaf)
        return jax.tree_util.tree_unflatten(treedef, new_leaves)

    params = set_bias(params)

    obs_preprocess = ObservationsPreprocessNoop.create()

    return PolicyState(
        apply_fn=actor_critic.apply,
        rnn_reset_fn=actor_critic.clear_recurrent_state,
        params=params,
        batch_stats=jax.vmap(lambda _: {})(jnp.arange(P)),
        obs_preprocess=obs_preprocess,
        obs_preprocess_state=jax.vmap(
            lambda _: obs_preprocess.init_state(example_obs, False))(
                jnp.arange(P)),
        reward_hyper_params=None,
        get_episode_scores_fn=lambda x: (0.0, 0.0),
        episode_score=None,
        mmr=None,
    ), actor_critic


def run_fake_rollout(
    seed,
    num_steps,
    episode_len,
    num_current_policies,
    num_past_policies,
    num_teams,
    team_size,
    batch_size,
    self_play,
    cross_play,
    past_play,
    policy_chunk_size_override=0,
    data_shards=1,
):
    rollout_cfg = RolloutConfig.setup(
        num_current_policies=num_current_policies,
        num_past_policies=num_past_policies,
        num_teams=num_teams,
        team_size=team_size,
        sim_batch_size=batch_size,
        actions_cfg={"fake": None},
        self_play_portion=self_play,
        cross_play_portion=cross_play,
        past_play_portion=past_play,
        static_play_portion=0.0,
        policy_dtype=jnp.int32,
        reward_dtype=jnp.int32,
        policy_chunk_size_override=policy_chunk_size_override,
        data_shards=data_shards,
    )

    sim_cfg = FakeSimConfig(
        batch_size=batch_size,
        episode_len=episode_len,
        num_teams=num_teams,
        team_size=team_size,
    )
    sim_fns = make_fake_sim(sim_cfg)

    policy_states, actor_critic = build_fake_policy_states(rollout_cfg)

    @jax.jit
    def run():
        rollout_state = RolloutState.create(
            rollout_cfg=rollout_cfg,
            sim_fns=sim_fns,
            prng_key=random.PRNGKey(seed),
            rnn_states=actor_critic.init_recurrent_state(batch_size),
            init_sim_ctrl=jnp.zeros((1,), jnp.int32),
        )
        init_obs = rollout_state.cur_obs
        init_assignments = rollout_state.policy_assignments

        def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                              reorder_state, cb_state):
            emit = reorder_state.to_sim({
                "actions": policy_out["actions"]["fake"],
                "values": policy_out["critic"],
            })
            return cb_state, emit

        def post_step_cb(step_idx, rollout_state, dones, rewards,
                         episode_results, cb_state):
            emit = {
                "dones": dones,
                "rewards": rewards,
                # assignments BEFORE this step's reroll are what inference
                # used; emit the post-step ones for reroll validation too.
                "post_assignments": rollout_state.policy_assignments,
                "rnn_states": rollout_state.rnn_states,
            }
            return rollout_state, cb_state, emit

        final_state, _, (inference_emits, step_emits) = rollout_loop(
            rollout_state, policy_states, num_steps,
            post_inference_cb, post_step_cb, None,
            sample_actions=True)

        return init_obs, init_assignments, inference_emits, step_emits

    init_obs, init_assignments, inf, step = run()
    return (sim_cfg, rollout_cfg, jax.device_get(init_obs),
            np.asarray(init_assignments),
            jax.tree.map(np.asarray, inf), jax.tree.map(np.asarray, step))


def verify_rollout_data(sim_cfg, rollout_cfg, init_obs, init_assignments,
                        inf, step):
    """Numpy oracle for the integer recurrence, checked bit-exactly."""
    T = inf["actions"].shape[0]
    B = sim_cfg.batch_size

    # int32 wrap-around arithmetic matches XLA exactly.
    o = np.asarray(init_obs["o"]).reshape(B).astype(np.int32)
    c = np.asarray(init_obs["c"]).reshape(B).astype(np.int32)
    h = np.zeros(B, dtype=np.int32)
    assignment = init_assignments.reshape(B).astype(np.int32).copy()

    np.seterr(over="ignore")
    for t in range(T):
        bias = assignment  # policy index == bias
        x0 = o + bias
        y = x0 + h
        new_h = h + np.int32(2) * x0

        actions = inf["actions"][t]  # [B, 3]
        np.testing.assert_array_equal(actions[:, 0], y, err_msg=f"t={t} y")
        np.testing.assert_array_equal(
            actions[:, 1], bias, err_msg=f"t={t} bias")
        np.testing.assert_array_equal(actions[:, 2], c, err_msg=f"t={t} c")

        values = inf["values"][t].reshape(B)
        np.testing.assert_array_equal(values, new_h, err_msg=f"t={t} value")

        rewards = step["rewards"][t].reshape(B)
        np.testing.assert_array_equal(rewards, y + 2, err_msg=f"t={t} reward")

        # sim transition
        c = (c + 1) % sim_cfg.episode_len
        dones = step["dones"][t].reshape(B)
        expected_dones = c == 0
        np.testing.assert_array_equal(dones, expected_dones,
                                      err_msg=f"t={t} dones")

        o = y + 1
        h = np.where(expected_dones, 0, new_h)

        rnn = step["rnn_states"][t].reshape(B)
        np.testing.assert_array_equal(rnn, h, err_msg=f"t={t} rnn")

        # Assignments may change only where episodes ended (and only for
        # non-team-0 agents); all other slots must be untouched.
        new_assignment = step["post_assignments"][t].reshape(B)
        unchanged = ~expected_dones
        np.testing.assert_array_equal(
            new_assignment[unchanged], assignment[unchanged],
            err_msg=f"t={t} assignment changed without done")
        assignment = new_assignment


def check_assignments(rollout_cfg, assignments):
    """Matchmaking invariants (reference: tests/test_rollouts.py:493-551).

    Shard-major layouts (pbt.num_data_shards > 1) repeat the whole
    self|cross|past|static structure per shard block — check each block
    against the per-shard view."""
    pbt = rollout_cfg.pbt
    if pbt.num_data_shards > 1:
        import dataclasses
        shard_cfg = dataclasses.replace(
            rollout_cfg, pbt=pbt.shard_view(),
            sim_batch_size=rollout_cfg.sim_batch_size // pbt.num_data_shards)
        for blk in assignments.reshape(pbt.num_data_shards, -1):
            check_assignments(shard_cfg, blk)
        return
    B = assignments.shape[0]
    a = assignments.reshape(-1, pbt.num_teams, pbt.team_size)

    # Teams are policy-uniform.
    assert (a == a[:, :, 0:1]).all()

    self_end = pbt.self_play_batch_size
    cross_end = self_end + pbt.cross_play_batch_size
    past_end = cross_end + pbt.past_play_batch_size

    flat = assignments.reshape(-1)
    agents_per_world = pbt.num_teams * pbt.team_size

    if self_end > 0:
        assert (flat[:self_end] < pbt.num_current_policies).all()
    if cross_end > self_end:
        cross = flat[self_end:cross_end].reshape(
            -1, pbt.num_teams, pbt.team_size)
        # team 0 = block-assigned train policies
        assert (cross[:, 0, :] < pbt.num_current_policies).all()
        # opponents are train policies different from team 0's
        assert (cross[:, 1:, :] < pbt.num_current_policies).all()
        assert (cross[:, 1:, :] != cross[:, 0:1, 0:1]).all()
    if past_end > cross_end:
        past = flat[cross_end:past_end].reshape(
            -1, pbt.num_teams, pbt.team_size)
        assert (past[:, 0, :] < pbt.num_current_policies).all()
        assert (past[:, 1:, :] >= pbt.num_current_policies).all()
        assert (past[:, 1:, :] < pbt.total_num_policies).all()


CONFIGS = [
    # (num_steps, episode_len, n_cur, n_past, teams, team_size, batch,
    #  self, cross, past, chunk_override)
    (8, 3, 1, 0, 1, 1, 4, 1.0, 0.0, 0.0, 0),
    (16, 5, 4, 0, 1, 1, 32, 1.0, 0.0, 0.0, 0),
    (16, 5, 4, 0, 2, 2, 64, 1.0, 0.0, 0.0, 0),
    (16, 4, 4, 0, 2, 1, 64, 0.5, 0.5, 0.0, 8),
    (16, 4, 4, 2, 2, 1, 64, 0.5, 0.25, 0.25, 8),
    (20, 7, 8, 7, 2, 2, 256, 0.25, 0.5, 0.25, 16),
    (10, 3, 2, 1, 2, 2, 32, 0.0, 0.5, 0.5, 4),
]

# Reference-scale configs (reference: tests/test_rollouts.py:779-793): the
# batch-16384 / 16+7-policy regime where the partial-chunk padding and the
# pow2 chunk-size heuristics actually bite (heuristic chunk, no override).
LARGE_CONFIGS = [
    (12, 7, 16, 7, 2, 2, 16384, 0.25, 0.5, 0.25, 0),
    (10, 5, 16, 0, 2, 1, 16384, 0.5, 0.5, 0.0, 0),
    (10, 6, 8, 7, 4, 4, 8192, 0.25, 0.25, 0.5, 0),
]


@pytest.mark.parametrize("cfg_tuple", CONFIGS)
def test_fake_rollout_exact(cfg_tuple):
    (num_steps, episode_len, n_cur, n_past, teams, team_size, batch,
     self_p, cross_p, past_p, chunk) = cfg_tuple

    sim_cfg, rollout_cfg, init_obs, init_assignments, inf, step = (
        run_fake_rollout(
            seed=7, num_steps=num_steps, episode_len=episode_len,
            num_current_policies=n_cur, num_past_policies=n_past,
            num_teams=teams, team_size=team_size, batch_size=batch,
            self_play=self_p, cross_play=cross_p, past_play=past_p,
            policy_chunk_size_override=chunk))

    check_assignments(rollout_cfg, init_assignments)
    verify_rollout_data(
        sim_cfg, rollout_cfg, init_obs, init_assignments, inf, step)
    # Every post-step assignment snapshot also satisfies the invariants.
    check_assignments(rollout_cfg, step["post_assignments"][-1])


@pytest.mark.slow
@pytest.mark.parametrize("cfg_tuple", LARGE_CONFIGS)
def test_fake_rollout_exact_large(cfg_tuple):
    test_fake_rollout_exact(cfg_tuple)


@pytest.mark.parametrize("data_shards", [2, 4])
def test_fake_rollout_exact_shard_local_reorder(data_shards):
    """The integer oracle must hold bit-exactly with shard-local chunk
    construction (mesh data axis > 1)."""
    sim_cfg, rollout_cfg, init_obs, init_assignments, inf, step = (
        run_fake_rollout(
            seed=13, num_steps=16, episode_len=4,
            num_current_policies=4, num_past_policies=2,
            num_teams=2, team_size=1, batch_size=64,
            self_play=0.5, cross_play=0.25, past_play=0.25,
            policy_chunk_size_override=8, data_shards=data_shards))

    assert rollout_cfg.data_shards == data_shards
    check_assignments(rollout_cfg, init_assignments)
    verify_rollout_data(
        sim_cfg, rollout_cfg, init_obs, init_assignments, inf, step)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_shard_major_matchmaking_layout(D):
    """Shard-major matchmaking invariants (TODO round-5 #1): the whole
    self|cross|past structure repeats per shard block, every policy draws
    equal team-0 train agents from every shard through SHARD-LOCAL
    sim->train indices, opponents stay valid per block, and per-step
    rerolls never move team-0 rows."""
    from madrona_learn_tpu.pbt import (
        pbt_init_matchmaking, pbt_update_matchmaking)
    from madrona_learn_tpu.rollouts import (
        RolloutConfig, _compute_num_train_agents_per_policy,
        _compute_sim_to_train_indices)

    cfg = RolloutConfig.setup(
        num_current_policies=4, num_past_policies=2, num_teams=2,
        team_size=1, sim_batch_size=128, actions_cfg={"fake": None},
        self_play_portion=0.25, cross_play_portion=0.5,
        past_play_portion=0.25, static_play_portion=0.0, data_shards=D)
    pbt = cfg.pbt
    assert pbt.num_data_shards == D

    a = np.asarray(pbt_init_matchmaking(random.PRNGKey(0), pbt, None))
    check_assignments(cfg, a)

    B_local = 128 // D
    A = _compute_num_train_agents_per_policy(cfg)
    idx = np.asarray(_compute_sim_to_train_indices(cfg))
    assert idx.shape == (4, A // D)
    assert idx.min() >= 0 and idx.max() < B_local  # shard-LOCAL index space

    sv = pbt.shard_view()
    for s in range(D):
        blk = a[s * B_local:(s + 1) * B_local]
        for p in range(4):
            # Each policy owns exactly A/D team-0 train rows per shard.
            assert (blk[idx[p]] == p).all()
        ce = sv.self_play_batch_size
        cross = blk[ce:ce + sv.cross_play_batch_size].reshape(-1, 2, 1)
        assert ((cross[:, 1, 0] < 4)
                & (cross[:, 1, 0] != cross[:, 0, 0])).all()
        pe = ce + sv.cross_play_batch_size
        past = blk[pe:pe + sv.past_play_batch_size].reshape(-1, 2, 1)
        assert ((past[:, 1, 0] >= 4) & (past[:, 1, 0] < 6)).all()

    # Reroll every opponent: structure and team-0 rows must be preserved.
    a2, _ = pbt_update_matchmaking(
        jnp.asarray(a), None, jnp.ones((128, 1), bool), None,
        random.PRNGKey(1), pbt)
    a2 = np.asarray(a2)
    check_assignments(cfg, a2)
    for s in range(D):
        blk2 = a2[s * B_local:(s + 1) * B_local]
        for p in range(4):
            assert (blk2[idx[p]] == p).all()


def test_shard_major_train_gather_matches_flat_selection():
    """The vmapped shard-local train gather selects exactly the same
    (policy, agent-row) multiset as a direct global gather over the
    shard-major assignments — per policy, per shard — so training sees
    each policy's true team-0 data regardless of layout."""
    from madrona_learn_tpu.rollouts import (
        RolloutConfig, RolloutManager, _compute_sim_to_train_indices)

    D = 4
    cfg = RolloutConfig.setup(
        num_current_policies=4, num_past_policies=2, num_teams=2,
        team_size=1, sim_batch_size=128, actions_cfg={"fake": None},
        self_play_portion=0.25, cross_play_portion=0.5,
        past_play_portion=0.25, static_play_portion=0.0, data_shards=D)

    mgr = object.__new__(RolloutManager)
    mgr._cfg = cfg
    mgr._num_train_policies = 4
    mgr._num_train_agents_per_policy = (
        np.asarray(_compute_sim_to_train_indices(cfg)).shape[1] * D)
    mgr._sim_to_train_idxs = _compute_sim_to_train_indices(cfg)

    x = jnp.arange(128, dtype=jnp.int32)
    got = np.asarray(mgr._train_gather(x))  # [P, A]
    assert got.shape == (4, mgr._num_train_agents_per_policy)

    B_local = 128 // D
    idx = np.asarray(mgr._sim_to_train_idxs)
    want = np.stack([
        np.concatenate([s * B_local + idx[p] for s in range(D)])
        for p in range(4)])
    np.testing.assert_array_equal(got, want)
