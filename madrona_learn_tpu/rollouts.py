"""The rollout engine: resident, scan-based trajectory collection.

Capability parity with the reference rollout layer (reference:
rollouts.py:28-1211): policy-chunked batched inference over a PBT population,
per-step matchmaking updates, BPTT-chunked trajectory collection with RNN
start-state caching, bootstrap values, GAE/returns, and the reshape into
per-policy training sequences.

Architectural deviation: collection is a nested ``lax.scan``
(outer over BPTT chunks, inner over steps) whose *stacked outputs* form the
trajectory store directly in ``[C, T/C, P, B, ...]`` layout — the reference
instead preallocates a store and scatter-writes into it per step
(reference: rollouts.py:337-368). Scan stacking produces the same layout with
no scatter traffic and keeps the whole collect phase a single fused loop for
XLA. Rollout state (RNN state, obs) stays in sim order — which is the order
the (mesh-sharded) simulator owns — and data crosses into policy order only
around the inference call.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax, random

from .config import (
    ActionsConfig,
    ContinuousActionsConfig,
    DiscreteActionsConfig,
    MeshConfig,
    TrainConfig,
)
from .ops.gae import compute_advantages, compute_returns
from .ops.metrics import Metric, TrainingMetrics
from .ops.reorder import (
    PolicyBatchReorderState,
    compute_reorder_chunks,
    compute_reorder_chunks_sharded,
)
from .pbt import (
    PBTMatchmakeConfig,
    pbt_init_matchmaking,
    pbt_update_matchmaking,
)
from .struct import FrozenDict, PyTreeNode, field, freeze
from .utils.profile import profile


# ---------------------------------------------------------------------------
# Rollout configuration
# ---------------------------------------------------------------------------

def heuristic_policy_chunk_size(sim_batch_size: int,
                                total_num_policies: int,
                                min_chunk: int) -> int:
    """Pow2 chunk size from the guaranteed per-policy share, in the
    [64, 512] band, capped so reserved-partial-chunk padding stays <= half
    the batch.

    The chunk size trades reserved-partial-chunk PADDING ((P-1)*C rows of
    wasted inference) against per-chunk WEIGHT TRAFFIC (the per-step
    gather materializes one full per-policy parameter copy per chunk —
    ~(N/C + P) * params bytes every rollout step). The band was chosen by
    end-to-end sweeps on the earlier accelerator and is not yet
    re-measured on the GPU (benchmarks/profile_pbt.py --chunk-sweep).
    Seeding min_chunk from gcd(batch, P) instead drags C to the 64 floor
    (523 chunks at config #4). Shared with the benchmarks so they always
    measure the production geometry."""
    c = 1 << ((min_chunk - 1).bit_length())
    c = min(c, 512)
    c = max(c, min(64, sim_batch_size))
    pad_budget = sim_batch_size // (2 * max(total_num_policies - 1, 1))
    if pad_budget >= 1:
        c = min(c, max(64, 1 << (pad_budget.bit_length() - 1)))
    return c


@dataclass(frozen=True)
class RolloutConfig:
    sim_batch_size: int
    num_worlds: int
    actions_cfg: Dict[str, ActionsConfig]
    policy_chunk_size: int
    num_policy_chunks: int
    total_policy_batch_size: int
    # >1: shard-local reorder — the batch is split into this many contiguous
    # blocks, each with an independent chunk layout, so per-step reorder
    # gathers never cross a data-shard boundary (see
    # ops/reorder.py:compute_reorder_chunks_sharded).
    data_shards: int
    reward_gamma: float
    policy_dtype: jnp.dtype
    reward_dtype: jnp.dtype
    prob_dtype: jnp.dtype
    pbt: PBTMatchmakeConfig
    # Device mesh of the surrounding training/eval program, when one
    # exists. The rollout loop uses it to pin the read-only inference copy
    # of the policy population replicated across the mesh (see
    # parallel.mesh.replicate_for_inference); None = single device.
    mesh: Optional["MeshConfig"] = None

    @staticmethod
    def setup(
        num_current_policies: int,
        num_past_policies: int,
        num_teams: int,
        team_size: int,
        sim_batch_size: int,
        actions_cfg: Dict[str, ActionsConfig],
        self_play_portion: float,
        cross_play_portion: float,
        past_play_portion: float,
        static_play_portion: float,
        reward_gamma: float = 1.0,
        custom_policy_ids: List[int] = (),
        policy_dtype: jnp.dtype = jnp.float32,
        reward_dtype: jnp.dtype = jnp.float32,
        prob_dtype: jnp.dtype = jnp.float32,
        policy_chunk_size_override: int = 0,
        data_shards: int = 1,
        mesh_cfg: Optional[MeshConfig] = None,
    ) -> "RolloutConfig":
        # Shard-major matchmaking layout when the sim batch is data-sharded
        # and the play-mode slices divide: each shard block carries its own
        # self|cross|past|static sub-slices, so the sim->train emission
        # gather stays inside each shard (no replicated train store — see
        # RolloutManager._sim_to_train). Falls back to the flat layout
        # (gathers cross shards, GSPMD replicates the emission) when the
        # divisibility does not hold.
        mm_shards = 1
        if (data_shards > 1 and sim_batch_size % data_shards == 0
                and self_play_portion != 1.0):  # complex matchmaking only
            if PBTMatchmakeConfig.shardable(
                    num_current_policies, num_teams, team_size,
                    sim_batch_size, self_play_portion, cross_play_portion,
                    past_play_portion, static_play_portion, data_shards):
                mm_shards = data_shards
            else:
                # Advisory only (not warnings.warn: the layout is an auto
                # optimization the user never requested, and tiny test
                # batches routinely fail the divisibility): the flat
                # layout stays correct, just pays the replicated emission.
                import logging
                logging.getLogger(__name__).info(
                    "matchmaking layout cannot shard over data=%d (a "
                    "play-mode slice does not divide); the sim->train "
                    "emission will replicate the train store over the "
                    "data axis — size the batch/portions to divide for "
                    "collective-free emission", data_shards)

        pbt = PBTMatchmakeConfig.setup(
            num_current_policies=num_current_policies,
            num_past_policies=num_past_policies,
            num_teams=num_teams,
            team_size=team_size,
            sim_batch_size=sim_batch_size,
            self_play_portion=self_play_portion,
            cross_play_portion=cross_play_portion,
            past_play_portion=past_play_portion,
            static_play_portion=static_play_portion,
            custom_policy_ids=custom_policy_ids,
            num_data_shards=mm_shards,
        )

        if pbt.complex_matchmaking:
            assert pbt.num_teams > 1
            assert pbt.num_current_policies > 1 or pbt.num_past_policies > 0

            # Smallest per-policy share any ACTIVE play-mode slice
            # guarantees, seeded from the average share. (Rounds 1-4
            # seeded from gcd(batch, P) — e.g. gcd(32768, 12) = 4 — which
            # dragged the chunk size to the 64 floor and quintupled the
            # per-step weight-gather traffic; see
            # heuristic_policy_chunk_size.)
            min_chunk = sim_batch_size // pbt.total_num_policies
            if pbt.self_play_batch_size > 0:
                min_chunk = min(
                    min_chunk,
                    pbt.self_play_batch_size // pbt.num_current_policies)
            if pbt.cross_play_batch_size > 0:
                min_chunk = min(
                    min_chunk,
                    pbt.cross_play_batch_size // pbt.num_current_policies)
            if pbt.past_play_batch_size > 0:
                min_chunk = min(
                    min_chunk,
                    pbt.past_play_batch_size // pbt.num_past_policies)
            if pbt.static_play_batch_size > 0:
                min_chunk = min(
                    min_chunk,
                    pbt.static_play_batch_size // pbt.total_num_policies)
            assert min_chunk > 0

            # Pow2 per-policy share, 64 floor (per-chunk matmuls big enough
            # to keep the matrix units busy), capped so reserved-partial-
            # chunk padding stays <= half the batch — every policy owns one
            # reserved partial chunk, so inference always processes
            # (P-1)*C padding rows on top of the batch
            # (benchmarks/infer_bench.py --chunk sweeps it).
            policy_chunk_size = heuristic_policy_chunk_size(
                sim_batch_size, pbt.total_num_policies, min_chunk)
        else:
            assert num_past_policies == 0
            policy_chunk_size = sim_batch_size // num_current_policies

        if policy_chunk_size_override != 0:
            policy_chunk_size = policy_chunk_size_override

        if not pbt.complex_matchmaking:
            data_shards = 1
        if data_shards > 1:
            assert sim_batch_size % data_shards == 0, (
                f"sim_batch_size ({sim_batch_size}) must divide by "
                f"data_shards ({data_shards}) for shard-local reorder")
            shard_batch = sim_batch_size // data_shards
            shard_cap = max(8, shard_batch // 2)
            if policy_chunk_size_override != 0:
                # An explicit override is a contract — never silently
                # reshape it; the user must pick a chunk that fits a shard.
                assert policy_chunk_size <= shard_cap, (
                    f"rollout_policy_chunk_size_override "
                    f"({policy_chunk_size}) exceeds the per-data-shard cap "
                    f"({shard_cap} = max(8, sim_batch/data_shards/2)); "
                    f"lower the override or the data mesh axis")
            policy_chunk_size = min(policy_chunk_size, shard_cap)
            # Per-shard worst case, replicated across shards.
            num_policy_chunks = data_shards * (
                -(shard_batch // -policy_chunk_size)
                + pbt.total_num_policies - 1)
        else:
            # Enough chunks to cover the batch plus worst-case per-policy
            # padding.
            num_policy_chunks = -(sim_batch_size // -policy_chunk_size)
            if pbt.complex_matchmaking:
                num_policy_chunks += pbt.total_num_policies - 1

        return RolloutConfig(
            sim_batch_size=sim_batch_size,
            num_worlds=sim_batch_size // (pbt.team_size * pbt.num_teams),
            actions_cfg=actions_cfg,
            policy_chunk_size=policy_chunk_size,
            num_policy_chunks=num_policy_chunks,
            total_policy_batch_size=num_policy_chunks * policy_chunk_size,
            data_shards=data_shards,
            reward_gamma=reward_gamma,
            policy_dtype=policy_dtype,
            reward_dtype=reward_dtype,
            prob_dtype=prob_dtype,
            pbt=pbt,
            mesh=mesh_cfg,
        )


def _rollout_cfg_shard_view(cfg: RolloutConfig, num_shards: int):
    """Per-shard view of a data-sharded rollout config (manual collect).

    One contiguous ``sim_batch_size / D`` block: batch sizes, world count
    and chunk counts divide by D; the matchmaking config becomes its
    single-shard view; ``data_shards`` collapses to 1 (each shard computes
    the flat layout locally). Mirrors ``PBTMatchmakeConfig.shard_view``.
    """
    D = num_shards
    if D <= 1:
        return cfg
    assert cfg.sim_batch_size % D == 0 and cfg.num_worlds % D == 0
    # D > 1 implies the complex shard-major layout: _manual_collect_enabled
    # keeps the simple path (one whole-batch chunk, single sampling key —
    # not slice-equivariant) on GSPMD collect.
    assert cfg.pbt.complex_matchmaking, (
        "per-shard views exist only for shard-major complex matchmaking")
    assert cfg.data_shards == D and cfg.pbt.num_data_shards == D, (
        "manual collect requires the shard-major matchmaking layout "
        "at the mesh's data axis (RolloutConfig.setup auto-enables it "
        "when the play-mode slices divide)")
    num_chunks = cfg.num_policy_chunks // D
    return dataclasses.replace(
        cfg,
        sim_batch_size=cfg.sim_batch_size // D,
        num_worlds=cfg.num_worlds // D,
        num_policy_chunks=num_chunks,
        total_policy_batch_size=num_chunks * cfg.policy_chunk_size,
        data_shards=1,
        pbt=cfg.pbt.shard_view(),
    )


def _compute_reorder_state(assignments, rollout_cfg: RolloutConfig):
    if rollout_cfg.pbt.complex_matchmaking:
        if rollout_cfg.data_shards > 1:
            to_policy_idxs, to_sim_idxs = compute_reorder_chunks_sharded(
                assignments,
                rollout_cfg.pbt.total_num_policies,
                rollout_cfg.policy_chunk_size,
                rollout_cfg.num_policy_chunks // rollout_cfg.data_shards,
                rollout_cfg.data_shards,
            )
        else:
            to_policy_idxs, to_sim_idxs = compute_reorder_chunks(
                assignments,
                rollout_cfg.pbt.total_num_policies,
                rollout_cfg.policy_chunk_size,
                rollout_cfg.num_policy_chunks,
            )
    else:
        to_policy_idxs = None
        to_sim_idxs = None

    return PolicyBatchReorderState(
        to_policy_idxs=to_policy_idxs,
        to_sim_idxs=to_sim_idxs,
        policy_dims=(
            rollout_cfg.pbt.total_num_policies,
            rollout_cfg.policy_chunk_size,
        ),
        sim_dims=(rollout_cfg.sim_batch_size,),
        data_shards=(rollout_cfg.data_shards
                     if rollout_cfg.pbt.complex_matchmaking else 1),
    )


# ---------------------------------------------------------------------------
# Rollout state
# ---------------------------------------------------------------------------

class RolloutState(PyTreeNode):
    cfg: RolloutConfig = field(pytree_node=False)
    step_fn: Callable = field(pytree_node=False)
    load_ckpts_fn: Optional[Callable] = field(pytree_node=False)
    get_ckpts_fn: Optional[Callable] = field(pytree_node=False)
    sim_state: Any
    cur_obs: FrozenDict
    prng_key: jax.Array
    rnn_states: Any
    reorder_state: PolicyBatchReorderState
    policy_assignments: jax.Array
    sim_ctrl: jax.Array
    env_returns: jax.Array
    # The simulator declares (via sim_fns["data_parallel"] = True) that its
    # step is an independent per-world function of per-world state — safe
    # to run on world-slices inside the manual collect region. Host-callback
    # / FFI sims must leave this False (callbacks inside shard_map are not
    # supported); they keep the GSPMD collect path.
    data_parallel_sim: bool = field(
        pytree_node=False, default=False)

    @staticmethod
    def create(
        rollout_cfg: RolloutConfig,
        sim_fns,
        prng_key,
        rnn_states,
        init_sim_ctrl,
        static_play_assignments=None,
    ) -> "RolloutState":
        if rollout_cfg.pbt.num_static_play_matches > 0:
            assert static_play_assignments is not None
            assert (rollout_cfg.pbt.static_play_batch_size ==
                    static_play_assignments.shape[0])

        prng_key, assign_rnd = random.split(prng_key)
        policy_assignments = pbt_init_matchmaking(
            assign_rnd, rollout_cfg.pbt, static_play_assignments)
        assert policy_assignments.shape[0] == rollout_cfg.sim_batch_size

        reorder_state = _compute_reorder_state(policy_assignments, rollout_cfg)

        init_out = freeze(sim_fns["init"]())

        return RolloutState(
            cfg=rollout_cfg,
            step_fn=sim_fns["step"],
            load_ckpts_fn=sim_fns.get("load_ckpts", None),
            get_ckpts_fn=sim_fns.get("get_ckpts", None),
            sim_state=init_out["state"],
            cur_obs=init_out["obs"],
            prng_key=prng_key,
            rnn_states=rnn_states,
            reorder_state=reorder_state,
            policy_assignments=policy_assignments,
            sim_ctrl=init_sim_ctrl,
            env_returns=jnp.zeros(
                (rollout_cfg.sim_batch_size, 1),
                dtype=rollout_cfg.reward_dtype),
            data_parallel_sim=bool(sim_fns.get("data_parallel", False)),
        )

    def update(self, **changes) -> "RolloutState":
        return self.replace(**changes)

    def update_matchmaking(
        self,
        self_play_portion: float,
        cross_play_portion: float,
        past_play_portion: float,
        static_play_portion: float,
        policy_assignments: jax.Array,
    ) -> "RolloutState":
        """Switch play-mode portions (e.g. train <-> all-pairs Elo eval).

        The shard-major layout follows the new portions: it sticks at the
        rollout config's data-shard count when the new play-mode slices
        divide, and falls back to the flat layout otherwise (the caller's
        ``policy_assignments`` must match — both sides of the train/eval
        switch construct them through ``pbt_init_matchmaking`` or
        world-aligned static tables, which respect the active layout).
        """
        mm_shards = 1
        if (self.cfg.data_shards > 1 and self_play_portion != 1.0
                and PBTMatchmakeConfig.shardable(
                    self.cfg.pbt.num_current_policies,
                    self.cfg.pbt.num_teams,
                    self.cfg.pbt.team_size,
                    self.cfg.sim_batch_size,
                    self_play_portion,
                    cross_play_portion,
                    past_play_portion,
                    static_play_portion,
                    self.cfg.data_shards)):
            mm_shards = self.cfg.data_shards
        new_pbt = PBTMatchmakeConfig.setup(
            self.cfg.pbt.num_current_policies,
            self.cfg.pbt.num_past_policies,
            self.cfg.pbt.num_teams,
            self.cfg.pbt.team_size,
            self.cfg.sim_batch_size,
            self_play_portion,
            cross_play_portion,
            past_play_portion,
            static_play_portion,
            self.cfg.pbt.custom_policy_ids,
            num_data_shards=mm_shards,
        )
        new_cfg = dataclasses.replace(self.cfg, pbt=new_pbt)
        return self.replace(
            cfg=new_cfg,
            reorder_state=_compute_reorder_state(policy_assignments, new_cfg),
            policy_assignments=policy_assignments,
        )

    # Simulator-state snapshot passthrough (reference: rollouts.py:300-309).
    # Stateful engines (Madrona-style custom calls) take no argument and
    # return only obs; functional sims take the state and return a
    # {'state', 'obs'} dict.
    def get_current_checkpoints(self):
        try:
            return self.get_ckpts_fn(self.sim_state)
        except TypeError:
            return self.get_ckpts_fn()

    def load_checkpoints_into_sim(self, ckpts):
        assert ckpts.ndim == 2
        trigger = jnp.ones((ckpts.shape[0], 1), jnp.int32)
        out = self.load_ckpts_fn(trigger, ckpts)
        if isinstance(out, dict) and "state" in out:
            return self.update(
                sim_state=out["state"],
                cur_obs=freeze(out["obs"]))
        return self.update(cur_obs=freeze(out))


# ---------------------------------------------------------------------------
# Training data container
# ---------------------------------------------------------------------------

class RolloutData(PyTreeNode):
    """Per-policy training sequences: leaves are [num_seqs, T/C, ...]
    (after the per-policy vmap strips the leading policy axis)."""

    data: FrozenDict
    num_train_seqs_per_policy: int = field(pytree_node=False)
    num_train_policies: int = field(pytree_node=False)

    def all(self):
        return self.data

    def minibatch(self, indices):
        mb = jax.tree.map(lambda x: jnp.take(x, indices, 0), self.data)
        mb, rnn_start_states = mb.pop("rnn_start_states")
        # Time-major for the sequence scan.
        mb = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), mb)
        return mb.copy({"rnn_start_states": rnn_start_states})

    def flatten_time(self):
        flattened = jax.tree.map(
            lambda x: x.reshape(-1, 1, *x.shape[2:]), self.data)
        return self.replace(data=flattened)


# ---------------------------------------------------------------------------
# The rollout loop
# ---------------------------------------------------------------------------

# Unroll factor for the per-step sim/inference scan. The step body is many
# small launch-bound ops at rollout batch sizes; unrolling lets XLA fuse
# across step boundaries. Chosen on the earlier accelerator; not yet
# re-measured on the GPU. lax.scan handles non-dividing step counts.
_ROLLOUT_SCAN_UNROLL = 2


def rollout_loop(
    rollout_state: RolloutState,
    policy_states,
    num_steps: int,
    post_inference_cb: Callable,
    post_step_cb: Callable,
    cb_state: Any,
    start_step_idx: Union[int, jax.Array] = 0,
    shard_info: Optional[Tuple[str, int]] = None,
    chunkwise_rnn: bool = False,
    **policy_kwargs,
):
    """Scan ``num_steps`` sim steps.

    Callbacks receive/return a carry (``cb_state``) and may emit per-step
    pytrees that come back stacked along a leading time axis:

    - ``post_inference_cb(step_idx, policy_obs, preprocessed_obs, policy_out,
      reorder_state, cb_state) -> (cb_state, emit_or_None)``
    - ``post_step_cb(step_idx, rollout_state, dones, rewards,
      episode_results, cb_state) -> (rollout_state, cb_state, emit_or_None)``

    Returns ``(rollout_state, cb_state, (stacked_inference_emits,
    stacked_step_emits))``. ``policy_states`` is loop-invariant (closure), so
    XLA keeps weights resident across steps.

    ``shard_info=(axis_name, D)`` marks a call from inside the manual
    collect region: ``rollout_state`` holds this data shard's slice (local
    cfg = the global cfg's shard view), while the PRNG carry is replicated.
    Key derivation then reproduces the global program bit-for-bit — split
    into the GLOBAL chunk/shard counts and take this shard's slice — so
    manual and GSPMD collects sample identical actions and matchups.

    ``chunkwise_rnn=True`` (complex matchmaking only) keeps the RNN state
    resident in POLICY-CHUNK order across steps instead of round-tripping
    it through sim order every step: resets apply on a gathered chunk-
    order dones mask, and the old→new chunk remap after matchmaking is
    ONE composed gather (to_sim(old)∘to_policy(new) on the index tables)
    — replacing a full [sim_batch, rnn] scatter + gather pair per step
    (the #2 sink of the round-5 PBT attribution). Values are bit-identical
    (gathers are exact); the carry's ``rnn_states`` holds the CHUNK layout
    inside the loop (converted at entry/exit), so callbacks that read
    ``rollout_state.rnn_states`` mid-loop (eval's step_cb) must leave
    this off.
    """
    cfg = rollout_state.cfg
    shard_axis, num_shards = shard_info if shard_info else (None, 1)
    chunkwise_rnn = chunkwise_rnn and cfg.pbt.complex_matchmaking

    if shard_axis is None:
        # Multi-device mesh: the per-step per-chunk weight gather must read
        # a REPLICATED population — from a policy-sharded one it lowers to a
        # [num_chunks x params] all-reduce over the policy axis every step
        # (44.85 GB/device/update at config-#5 scale, counted from the
        # compiled collectives). One all-gather per loop instead. (Inside
        # the manual region the caller already passes a replicated copy.)
        from .parallel.mesh import replicate_for_inference
        policy_states = replicate_for_inference(policy_states, cfg.mesh)

    def obs_preprocess_fn(state, obs):
        return state.obs_preprocess.preprocess(
            state.obs_preprocess_state, obs, True)

    @jax.vmap
    def policy_fn(state, sample_key, rnn_states, preprocessed_obs):
        return state.apply_fn(
            {"params": state.params, "batch_stats": state.batch_stats},
            sample_key,
            rnn_states,
            preprocessed_obs,
            train=False,
            **policy_kwargs,
            method="rollout",
        )

    rnn_reset_fn = policy_states.rnn_reset_fn

    def chunk_remap(old_rs, new_rs, data):
        """Gather old-chunk-layout data directly into the new chunk layout.

        Composition on the index tables: new slot (b, c) wants sim row
        ``new.to_policy_idxs[b, c]``, which lives at old flat slot
        ``old.to_sim_idxs[that row]``. Sentinel rows (fully-empty chunks)
        resolve by clip, same as the two-step path. Stays shard-local for
        sharded layouts (vmapped over the explicit shard axis)."""
        D = new_rs.data_shards
        if D == 1:
            cidx = old_rs.to_sim_idxs.at[new_rs.to_policy_idxs].get(
                mode="clip")  # [B, C] into the old flat layout
            B, C = cidx.shape

            def txfm(x):
                flat = x.reshape(B * C, *x.shape[2:])
                return flat.at[cidx.reshape(-1)].get(mode="clip").reshape(
                    B, C, *x.shape[2:])
        else:
            cidx = jax.vmap(
                lambda ts, tp: ts.at[tp].get(mode="clip")
            )(old_rs.to_sim_idxs, new_rs.to_policy_idxs)  # [D, B_l, C]
            _, B_l, C = cidx.shape

            def txfm(x):
                xb = x.reshape(D, B_l * C, *x.shape[2:])
                out = jax.vmap(
                    lambda blk, ci: blk.at[ci.reshape(-1)].get(mode="clip")
                )(xb, cidx)  # [D, B_l*C, ...]
                return out.reshape(D * B_l, C, *x.shape[2:])

        return jax.tree.map(txfm, data)

    def reorder_policy_states(assignments, reorder_state):
        if not cfg.pbt.complex_matchmaking:
            return policy_states
        # Each chunk is policy-pure: its first assignment identifies the
        # policy whose weights the whole chunk runs with.
        state_idxs = reorder_state.to_policy(assignments)[:, 0]
        return jax.tree.map(lambda x: x[state_idxs], policy_states)

    def step(carry, step_idx):
        rollout_state, cb_state = carry

        prng_key = rollout_state.prng_key
        rnn_states = rollout_state.rnn_states
        sim_state = rollout_state.sim_state
        sim_obs = rollout_state.cur_obs
        reorder_state = rollout_state.reorder_state
        policy_assignments = rollout_state.policy_assignments

        with profile("Policy Inference"):
            prng_key, step_key = random.split(prng_key)
            if shard_axis is None:
                step_keys = random.split(step_key, cfg.num_policy_chunks)
            else:
                # This shard's contiguous slice of the GLOBAL per-chunk key
                # set (chunk layout is shard-major, so slice s owns chunks
                # [s*local, (s+1)*local)).
                all_keys = random.split(
                    step_key, cfg.num_policy_chunks * num_shards)
                step_keys = lax.dynamic_slice_in_dim(
                    all_keys,
                    lax.axis_index(shard_axis) * cfg.num_policy_chunks,
                    cfg.num_policy_chunks)

            # Sub-scopes map XProf device self-time onto the complex-
            # matchmaking cost centers (scripts/xprof_summary.py --hlo
            # joins them through HLO op_name metadata); XLA may fuse
            # across scope boundaries, attributing a merged fusion to one
            # of them — still the only in-context attribution available.
            with profile("Gather Chunk Weights"):
                chunk_policy_states = reorder_policy_states(
                    policy_assignments, reorder_state)
            with profile("Reorder To Policy"):
                if chunkwise_rnn:
                    # RNN carry is already in this step's chunk layout.
                    chunk_rnn_states = rnn_states
                    policy_obs = reorder_state.to_policy(sim_obs)
                else:
                    chunk_rnn_states, policy_obs = reorder_state.to_policy(
                        (rnn_states, sim_obs))

            with profile("Obs Preprocess"):
                preprocessed_obs = obs_preprocess_fn(
                    chunk_policy_states, policy_obs)

            with profile("Policy Apply"):
                policy_out, chunk_rnn_states = policy_fn(
                    chunk_policy_states, step_keys, chunk_rnn_states,
                    preprocessed_obs)

            cb_state, inference_emit = post_inference_cb(
                step_idx, policy_obs, preprocessed_obs, policy_out,
                reorder_state, cb_state)

            with profile("Reorder To Sim"):
                if chunkwise_rnn:
                    rnn_states = chunk_rnn_states
                else:
                    # RNN state lives in (stable) sim order across steps;
                    # policy-chunk order shifts when assignments change.
                    rnn_states = reorder_state.to_sim(chunk_rnn_states)

        with profile("Rollout Step"):
            step_input = freeze({
                "state": sim_state,
                "actions": reorder_state.to_sim(policy_out["actions"]),
                "resets": jnp.zeros((cfg.num_worlds, 1), jnp.int32),
                "sim_ctrl": rollout_state.sim_ctrl,
            })

            pbt_inputs = {"policy_assignments": policy_assignments}
            if policy_states.reward_hyper_params is not None:
                pbt_inputs["reward_hyper_params"] = (
                    policy_states.reward_hyper_params)
            step_input = step_input.copy({"pbt": FrozenDict(pbt_inputs)})

            with profile("Sim Step"):
                step_output = freeze(
                    rollout_state.step_fn(step_input))

            sim_state = step_output["state"]
            dones = step_output["dones"].astype(jnp.bool_)
            rewards = step_output["rewards"].astype(cfg.reward_dtype)
            sim_obs = step_output["obs"]

            if cfg.reward_gamma == 1.0:
                # Avoid float promotion so integer reward dtypes (fake-sim
                # exact tests) stay exact.
                env_returns = rewards + rollout_state.env_returns
            else:
                env_returns = (
                    rewards + cfg.reward_gamma * rollout_state.env_returns
                ).astype(cfg.reward_dtype)

            if chunkwise_rnn:
                rnn_states = rnn_reset_fn(
                    rnn_states, reorder_state.to_policy(dones))
            else:
                rnn_states = rnn_reset_fn(rnn_states, dones)

            episode_results = step_output.get("pbt", FrozenDict()).get(
                "episode_results", None)

            with profile("Matchmaking"):
                if (shard_axis is None or num_shards == 1
                        or not cfg.pbt.complex_matchmaking):
                    policy_assignments, prng_key = pbt_update_matchmaking(
                        policy_assignments, policy_states, dones,
                        episode_results, prng_key, cfg.pbt)
                else:
                    # Local reroll with this shard's key from the GLOBAL
                    # split — bit-identical to the shard-major layout's
                    # vmapped reroll (pbt.pbt_update_matchmaking D>1
                    # branch: keys[0] carries, keys[1+s] rerolls shard s).
                    keys = random.split(prng_key, num_shards + 1)
                    my_key = keys[1:][lax.axis_index(shard_axis)]
                    policy_assignments, _ = pbt_update_matchmaking(
                        policy_assignments, policy_states, dones,
                        episode_results, my_key, cfg.pbt)
                    prng_key = keys[0]

            with profile("Compute Reorder State"):
                new_reorder_state = _compute_reorder_state(
                    policy_assignments, cfg)

            if chunkwise_rnn:
                with profile("RNN Chunk Remap"):
                    rnn_states = chunk_remap(
                        reorder_state, new_reorder_state, rnn_states)
            reorder_state = new_reorder_state

            rollout_state = rollout_state.update(
                prng_key=prng_key,
                rnn_states=rnn_states,
                sim_state=sim_state,
                cur_obs=sim_obs,
                reorder_state=reorder_state,
                policy_assignments=policy_assignments,
                env_returns=env_returns,
            )

            rollout_state, cb_state, step_emit = post_step_cb(
                step_idx, rollout_state, dones, rewards, episode_results,
                cb_state)

            rollout_state = rollout_state.update(
                env_returns=jnp.where(dones, 0, rollout_state.env_returns))

        return (rollout_state, cb_state), (inference_emit, step_emit)

    if chunkwise_rnn:
        rollout_state = rollout_state.update(
            rnn_states=rollout_state.reorder_state.to_policy(
                rollout_state.rnn_states))

    (rollout_state, cb_state), emits = lax.scan(
        step,
        (rollout_state, cb_state),
        start_step_idx + jnp.arange(num_steps),
        unroll=_ROLLOUT_SCAN_UNROLL)

    if chunkwise_rnn:
        rollout_state = rollout_state.update(
            rnn_states=rollout_state.reorder_state.to_sim(
                rollout_state.rnn_states))

    return rollout_state, cb_state, emits


def rollouts_reset(rollout_state: RolloutState, policy_states):
    """Step the sim once with resets raised; clear returns and RNN state."""
    cfg = rollout_state.cfg

    def zero_action(action_cfg):
        if isinstance(action_cfg, DiscreteActionsConfig):
            return jnp.zeros(
                (cfg.sim_batch_size, len(action_cfg.actions_num_buckets)),
                jnp.int32)
        if isinstance(action_cfg, ContinuousActionsConfig):
            return jnp.zeros(
                (cfg.sim_batch_size, 1, action_cfg.num_dims), jnp.float32)
        raise AssertionError("unknown action config")

    step_input = freeze({
        "state": rollout_state.sim_state,
        "actions": {
            k: zero_action(v) for k, v in cfg.actions_cfg.items()},
        "resets": jnp.ones((cfg.num_worlds, 1), jnp.int32),
        "sim_ctrl": rollout_state.sim_ctrl,
    })

    pbt_inputs = {
        "policy_assignments": jnp.zeros((cfg.sim_batch_size, 1), jnp.int32)}
    if policy_states.reward_hyper_params is not None:
        pbt_inputs["reward_hyper_params"] = policy_states.reward_hyper_params
    step_input = step_input.copy({"pbt": FrozenDict(pbt_inputs)})

    step_output = freeze(rollout_state.step_fn(step_input))

    dones = step_output["dones"].astype(jnp.bool_)
    rnn_states = policy_states.rnn_reset_fn(
        rollout_state.rnn_states, jnp.ones_like(dones))

    return rollout_state.update(
        rnn_states=rnn_states,
        sim_state=step_output["state"],
        cur_obs=step_output["obs"],
        env_returns=jnp.zeros_like(rollout_state.env_returns),
    )


# ---------------------------------------------------------------------------
# Training collection manager
# ---------------------------------------------------------------------------

class RolloutManager:
    def __init__(
        self,
        train_cfg: TrainConfig,
        init_rollout_state: RolloutState,
        example_policy_states,
    ):
        self._cfg = init_rollout_state.cfg
        self._critic_outputs_distribution = (
            train_cfg.dreamer_v3_critic or train_cfg.hlgauss_critic)

        self._num_bptt_chunks = train_cfg.num_bptt_chunks
        assert train_cfg.steps_per_update % train_cfg.num_bptt_chunks == 0, (
            f"steps_per_update ({train_cfg.steps_per_update}) must be "
            f"divisible by num_bptt_chunks ({train_cfg.num_bptt_chunks})")
        self._num_bptt_steps = (
            train_cfg.steps_per_update // train_cfg.num_bptt_chunks)

        self._num_train_policies = self._cfg.pbt.num_current_policies
        self._num_train_agents_per_policy = (
            _compute_num_train_agents_per_policy(self._cfg))
        self._num_train_seqs_per_policy = (
            self._num_train_agents_per_policy * self._num_bptt_chunks)

        self._sim_to_train_idxs = jax.jit(
            partial(_compute_sim_to_train_indices, self._cfg))()
        assert (self._sim_to_train_idxs.shape[1]
                * self._cfg.pbt.num_data_shards ==
                self._num_train_agents_per_policy)

        self._use_advantages = train_cfg.compute_advantages
        self._gamma = train_cfg.gamma
        self._gae_lambda = train_cfg.gae_lambda
        self._mesh_cfg = train_cfg.mesh

        # Approximate train-store footprint (obs-dominated; actions/values/
        # rewards/dones add a few more scalars per row). Used by
        # ppo.resolve_stratify's fallback warning to state the concrete
        # replication cost when stratification cannot engage on a
        # multi-chip mesh.
        obs_bytes_per_agent = sum(
            math.prod(leaf.shape[1:]) * leaf.dtype.itemsize
            for leaf in jax.tree.leaves(init_rollout_state.cur_obs))
        self.approx_train_store_bytes = (
            self._num_train_policies * self._num_train_agents_per_policy
            * train_cfg.steps_per_update * obs_bytes_per_agent)

    def add_metrics(self, train_cfg: TrainConfig, metrics: FrozenDict):
        new_metrics = {
            "Rewards": Metric.init(True),
            "Est Returns": Metric.init(True),
            "Env Returns": Metric.init(True),
            "Values": Metric.init(True),
            "Bootstrap Values": Metric.init(True),
        }
        if train_cfg.compute_advantages:
            new_metrics["Advantages"] = Metric.init(True)
        return metrics.copy(new_metrics)

    # -- layout helpers ------------------------------------------------------
    #
    # Multi-chip note: with the flat
    # matchmaking layout (pbt.num_data_shards == 1) the sim->train gathers
    # below use STATIC indices that cross data shards, so GSPMD lowers them
    # as mask+psum and the train store is born REPLICATED over ``data``
    # (~0.76 GB/device/update at the weak-scaled config-#5 shape). Pinning
    # the outputs data-sharded was tried and measured WORSE (the psum still
    # happens, plus a reshard). The fix is the shard-major matchmaking
    # layout (pbt.num_data_shards > 1, auto-enabled in RolloutConfig.setup
    # when the play-mode slices divide): each policy draws equal train
    # agents from every data shard, the indices are shard-LOCAL, and the
    # gather runs vmapped over the explicit shard axis — zero collectives,
    # like ops/reorder.py's chunk layout. The resulting train rows are a
    # fixed permutation of the flat layout's (shard-major instead of
    # slice-major), which no consumer depends on.

    def _train_gather(self, x):
        """sim order [B, ...] -> train order [P, A, ...] (team-0 agents)."""
        D = self._cfg.pbt.num_data_shards
        if D == 1:
            return x[self._sim_to_train_idxs]
        xb = x.reshape(D, -1, *x.shape[1:])
        out = jax.vmap(lambda blk: blk[self._sim_to_train_idxs])(xb)
        out = jnp.swapaxes(out, 0, 1)  # [P, D, A/D, ...]
        return out.reshape(
            self._num_train_policies,
            self._num_train_agents_per_policy, *x.shape[1:])

    def _sim_to_train(self, data, reorder_state):
        if self._cfg.pbt.complex_matchmaking:
            to_train = self._train_gather
        else:
            to_train = lambda x: x.reshape(
                self._num_train_policies, -1, *x.shape[1:])
        return jax.tree.map(to_train, data)

    def _policy_to_train(self, data, reorder_state):
        if not self._cfg.pbt.complex_matchmaking:
            return data  # policy order == train order on the simple path

        # Compose chunk->sim->train into ONE gather (round 5): the two-step
        # path (to_sim then _train_gather) materializes a full [sim_batch]
        # intermediate for every emitted leaf on every rollout step; the
        # XProf attribution put the per-step emission at 22% of the
        # config-#4 update (BASELINE.md round-5 table). The composition
        # runs on the [P, A] int32 index table instead of the data.
        to_sim_idxs = reorder_state.to_sim_idxs
        if to_sim_idxs is None:
            def to_train(x):
                return self._train_gather(reorder_state.to_sim(x))
            return jax.tree.map(to_train, data)

        # Two independent shard counts: D shards the chunk layout
        # (reorder), E shards the emission layout (shard-major
        # matchmaking). E > 1 implies D == E (RolloutConfig.setup); E == 1
        # with D > 1 happens when the batch divides for the reorder but
        # not for the matchmaking layout — there the composed indices
        # cross shard blocks, exactly like the two-step path did.
        D = reorder_state.data_shards
        E = self._cfg.pbt.num_data_shards
        if E > 1:
            # Shard-local composition: per-shard chunk-flat indices stay in
            # local space so the vmapped gather partitions collective-free
            # (same construction as _train_gather).
            cidx = jax.vmap(lambda ts: ts[self._sim_to_train_idxs])(
                to_sim_idxs)  # [D, P, A/D]

            def to_train(x):
                xb = x.reshape(D, -1, *x.shape[2:])
                out = jax.vmap(
                    lambda blk, ci: blk.at[ci].get(unique_indices=True)
                )(xb, cidx)  # [D, P, A/D, ...]
                out = jnp.swapaxes(out, 0, 1)
                return out.reshape(
                    self._num_train_policies,
                    self._num_train_agents_per_policy, *x.shape[2:])
        else:
            if D == 1:
                glob = to_sim_idxs  # [N] into the flat [B*C] chunk layout
            else:
                # Lift per-shard-local chunk indices to the global flat
                # chunk layout: block s occupies [s*B_local*C, (s+1)*...).
                b_local, c = reorder_state.to_policy_idxs.shape[1:3]
                glob = (to_sim_idxs
                        + (jnp.arange(D, dtype=to_sim_idxs.dtype)
                           * (b_local * c))[:, None]).reshape(-1)
            cidx = glob[self._sim_to_train_idxs]  # [P, A]

            def to_train(x):
                flat = x.reshape(-1, *x.shape[2:])
                return flat.at[cidx].get(unique_indices=True)

        return jax.tree.map(to_train, data)

    def _compute_value_estimate(self, critic_out):
        if self._critic_outputs_distribution:
            if isinstance(critic_out, jax.Array):
                # .mean() on a plain array would silently collapse the batch
                # axis and surface later as an inscrutable scan-carry shape
                # error in GAE.
                raise TypeError(
                    "TrainConfig.dreamer_v3_critic/hlgauss_critic is "
                    "enabled, but the model's critic returned a plain "
                    "array (a scalar critic such as DenseLayerCritic). "
                    "Either set dreamer_v3_critic=False in TrainConfig or "
                    "use a distributional critic (DreamerV3Critic / "
                    "HLGaussCritic).")
            return critic_out.mean()
        return critic_out

    # -- collection ----------------------------------------------------------

    def _manual_collect_enabled(self, rollout_state: RolloutState) -> bool:
        """Whether collect runs as a manual shard_map region over ``data``.

        Inside the region each data shard collects its own slice and the
        only collect-phase communication is the explicit reductions
        (obs-stat moments, metric merges). Requirements:

        - a multi-device mesh with ``manual_collect`` (the default);
        - ``model == 1``: a data-only region replicates params over the
          model axis, which would silently drop GSPMD's inference tensor
          parallelism for genuinely wide models — those keep GSPMD;
        - a sim that declares ``data_parallel`` (host-callback/FFI sims
          cannot run under shard_map);
        - D > 1 requires COMPLEX matchmaking with the shard-major layout
          active at the mesh's data axis: each shard then computes its own
          self|cross|past block locally, and the per-CHUNK sampling keys
          slice from the global stream bit-exactly. The simple path's one
          chunk spans the whole batch with a single sampling key, which is
          not slice-equivariant — it keeps GSPMD collect (D == 1 meshes,
          where nothing is sliced, still engage).
        """
        m = self._mesh_cfg
        if (m is None or m.num_devices <= 1
                or not getattr(m, "manual_collect", True)):
            return False
        if m.model > 1:
            return False
        if not rollout_state.data_parallel_sim:
            return False
        cfg = self._cfg
        D = m.data
        if D == 1:
            return True  # replicated region: nothing sliced
        if cfg.sim_batch_size % D or cfg.num_worlds % D:
            return False
        return (cfg.pbt.complex_matchmaking
                and cfg.pbt.num_data_shards == D
                and cfg.data_shards == D)

    def _shard_view_manager(self, num_shards: int,
                            local_cfg: RolloutConfig) -> "RolloutManager":
        """Lightweight per-shard clone serving one data shard's slice.

        ``_sim_to_train_idxs`` is ALREADY the shard-local table when the
        shard-major layout is active (``_compute_sim_to_train_indices``);
        the simple path uses reshapes and never reads it."""
        import copy
        m = copy.copy(self)
        m._cfg = local_cfg
        m._num_train_agents_per_policy = (
            self._num_train_agents_per_policy // num_shards)
        m._num_train_seqs_per_policy = (
            self._num_train_seqs_per_policy // num_shards)
        m._mesh_cfg = None  # single-shard semantics inside the region
        return m

    def collect(
        self,
        train_state_mgr,
        rollout_state: RolloutState,
        metrics: TrainingMetrics,
        user_start_rollouts_hook: Callable,
        user_finish_rollouts_hook: Callable,
        user_metrics_hook: Callable,
    ):
        # Replicate the read-only inference copy of the population ONCE per
        # collect, outside the bptt-chunk scan — rollout_loop's own
        # constraint (inside the scanned chunk body) then folds away. The
        # learn phase keeps consuming the policy-sharded original.
        from .parallel.mesh import replicate_for_inference
        policy_states = replicate_for_inference(
            train_state_mgr.policy_states, self._mesh_cfg)
        train_states = train_state_mgr.train_states

        if self._manual_collect_enabled(rollout_state):
            (user_state, rollout_state, rollout_data, obs_stats,
             metrics) = self._collect_manual(
                policy_states, train_states, train_state_mgr.user_state,
                rollout_state, metrics, user_start_rollouts_hook,
                user_finish_rollouts_hook, user_metrics_hook)
        else:
            (user_state, rollout_state, rollout_data, obs_stats,
             metrics) = self._collect_impl(
                policy_states, train_states.value_normalizer,
                train_states.value_normalizer_state,
                train_state_mgr.user_state, rollout_state, metrics,
                user_start_rollouts_hook, user_finish_rollouts_hook,
                user_metrics_hook)

        train_state_mgr = train_state_mgr.replace(user_state=user_state)
        return (train_state_mgr, rollout_state, rollout_data,
                obs_stats, metrics)

    def _collect_manual(
        self,
        policy_states,
        train_states,
        user_state,
        rollout_state: RolloutState,
        metrics: TrainingMetrics,
        user_start_rollouts_hook: Callable,
        user_finish_rollouts_hook: Callable,
        user_metrics_hook: Callable,
    ):
        """The collect phase as one manual shard_map region over ``data``.

        Each shard runs the FLAT single-shard collect on its contiguous
        batch block (the shard-major matchmaking layout makes every block
        self-contained), with PRNG derivation sliced from the global key
        streams (rollout_loop ``shard_info``) so results are bit-identical
        to the GSPMD program. Cross-shard reductions are the per-step obs
        EMA moments and the end-of-collect Welford metric merges — a few
        hundred bytes over ``data``, matching the round-4 comm budget's
        collect-phase rule.
        """
        from .parallel.mesh import DATA_AXIS, make_mesh

        mesh_cfg = self._mesh_cfg
        D = mesh_cfg.data
        mesh = make_mesh(mesh_cfg)
        Pspec = jax.sharding.PartitionSpec

        global_cfg = self._cfg
        local_cfg = _rollout_cfg_shard_view(global_cfg, D)
        local_mgr = self._shard_view_manager(D, local_cfg)

        sharded_dims = {global_cfg.sim_batch_size, global_cfg.num_worlds}

        def state_spec(x):
            if (hasattr(x, "ndim") and x.ndim >= 1
                    and x.shape[0] in sharded_dims):
                return Pspec(DATA_AXIS)
            return Pspec()

        # Plain-dict leaf passing (static RolloutState metadata — step_fn,
        # cfg, reorder tables — travels by closure; the reorder tables
        # re-derive locally inside and the global ones are rebuilt
        # outside).
        leaves_in = {
            "sim_state": rollout_state.sim_state,
            "cur_obs": rollout_state.cur_obs,
            "prng_key": rollout_state.prng_key,
            "rnn_states": rollout_state.rnn_states,
            "policy_assignments": rollout_state.policy_assignments,
            "sim_ctrl": rollout_state.sim_ctrl,
            "env_returns": rollout_state.env_returns,
        }
        in_leaf_specs = jax.tree.map(state_spec, leaves_in)

        vn = train_states.value_normalizer
        vn_state = train_states.value_normalizer_state

        def body(policy_states, vn_state, user_state, leaves, metrics):
            local_state = rollout_state.replace(
                cfg=local_cfg,
                reorder_state=_compute_reorder_state(
                    leaves["policy_assignments"], local_cfg),
                **leaves)
            (user_state, out_state, rollout_data, obs_stats,
             metrics) = local_mgr._collect_impl(
                policy_states, vn, vn_state, user_state, local_state,
                metrics, user_start_rollouts_hook,
                user_finish_rollouts_hook, user_metrics_hook,
                shard_info=(DATA_AXIS, D))
            leaves_out = {k: getattr(out_state, k) for k in leaves_in}
            return (user_state, leaves_out, rollout_data.data, obs_stats,
                    metrics)

        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(Pspec(), Pspec(), Pspec(), in_leaf_specs, Pspec()),
            out_specs=(Pspec(), in_leaf_specs, Pspec(None, DATA_AXIS),
                       Pspec(), Pspec()),
            check_vma=False)
        (user_state, leaves_out, rollout_data_leaves, obs_stats,
         metrics) = mapped(policy_states, vn_state, user_state,
                           leaves_in, metrics)

        rollout_state = rollout_state.replace(
            reorder_state=_compute_reorder_state(
                leaves_out["policy_assignments"], global_cfg),
            **leaves_out)
        rollout_data = RolloutData(
            data=rollout_data_leaves,
            num_train_seqs_per_policy=self._num_train_seqs_per_policy,
            num_train_policies=self._num_train_policies)
        return (user_state, rollout_state, rollout_data, obs_stats, metrics)

    def _collect_impl(
        self,
        policy_states,
        value_normalizer,
        value_normalizer_state,
        user_state,
        rollout_state: RolloutState,
        metrics: TrainingMetrics,
        user_start_rollouts_hook: Callable,
        user_finish_rollouts_hook: Callable,
        user_metrics_hook: Callable,
        shard_info: Optional[Tuple[str, int]] = None,
    ):
        axis_name = shard_info[0] if shard_info else None

        rollout_state, user_state = user_start_rollouts_hook(
            rollout_state, user_state)

        obs_preprocess = policy_states.obs_preprocess
        obs_preprocess_train_state = jax.tree.map(
            lambda s: s[0:self._num_train_policies],
            policy_states.obs_preprocess_state)

        def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                              reorder_state, cb_state):
            with profile("Pre Step Rollout Store"):
                values = self._policy_to_train(
                    self._compute_value_estimate(policy_out["critic"]),
                    reorder_state)
                train_obs, actions, log_probs = self._policy_to_train(
                    (preprocessed_obs, policy_out["actions"],
                     policy_out["log_probs"]),
                    reorder_state)

                emit = {
                    "obs": train_obs,
                    "actions": actions,
                    "log_probs": jax.tree.map(
                        lambda x: x.astype(self._cfg.prob_dtype), log_probs),
                    "values": values,
                }

                obs_stats = obs_preprocess.update_obs_stats(
                    obs_preprocess_train_state,
                    cb_state["obs_stats"],
                    step_idx,
                    self._policy_to_train(obs, reorder_state),
                    True,
                    axis_name=axis_name,
                )
                cb_state = dict(cb_state, obs_stats=obs_stats)
                return cb_state, emit

        def post_step_cb(step_idx, rollout_state, dones, rewards,
                         episode_results, cb_state):
            with profile("Post Step Rollout Store"):
                train_returns, train_dones = self._sim_to_train(
                    (rollout_state.env_returns, dones),
                    rollout_state.reorder_state)

                new_metric = jax.vmap(
                    partial(Metric.init_from_data_masked, True))(
                        train_returns, train_dones)
                cb_state = dict(
                    cb_state,
                    env_returns_metric=cb_state[
                        "env_returns_metric"].merge(new_metric))

                emit = self._sim_to_train(
                    {"dones": dones, "rewards": rewards},
                    rollout_state.reorder_state)
                return rollout_state, cb_state, emit

        @partial(jax.vmap, in_axes=None, out_axes=0,
                 axis_size=self._num_train_policies)
        def expand_metric(x):
            return x

        def iter_bptt_chunk(carry, bptt_chunk):
            rollout_state, cb_state = carry

            with profile("Cache RNN state"):
                rnn_start_states = self._sim_to_train(
                    rollout_state.rnn_states, rollout_state.reorder_state)

            rollout_state, cb_state, (per_step, step_data) = rollout_loop(
                rollout_state,
                policy_states,
                self._num_bptt_steps,
                post_inference_cb,
                post_step_cb,
                cb_state,
                start_step_idx=bptt_chunk * self._num_bptt_steps,
                shard_info=shard_info,
                # Chunk-order-resident RNN carry: bit-identical to the
                # default sim-order carry; it trades the per-step
                # to_sim/to_policy gathers for one composed remap gather
                # on the padded [num_chunks*C] layout. Opt in with
                # MADRONA_LEARN_TPU_CHUNKWISE_RNN=1; not measured on the
                # GPU.
                chunkwise_rnn=(os.environ.get(
                    "MADRONA_LEARN_TPU_CHUNKWISE_RNN") == "1"),
                sample_actions=True,
                return_debug=False,
            )

            chunk_data = FrozenDict(per_step).copy(step_data)
            return (rollout_state, cb_state), (chunk_data, rnn_start_states)

        cb_state = {
            "obs_stats": obs_preprocess.init_obs_stats(
                obs_preprocess_train_state, True),
            "env_returns_metric": expand_metric(Metric.init(True)),
        }

        (rollout_state, cb_state), (store, rnn_start_states) = lax.scan(
            iter_bptt_chunk,
            (rollout_state, cb_state),
            jnp.arange(self._num_bptt_chunks))
        # store leaves: [C, T/C, P, B, ...]; rnn_start_states: [C, P, B, ...]

        env_returns_metric = cb_state["env_returns_metric"]
        if axis_name is not None:
            env_returns_metric = env_returns_metric.merge_across(axis_name)
        metrics = metrics.update_metrics({
            "Env Returns": env_returns_metric,
        })

        with profile("Bootstrap Values"):
            bootstrap_values = self._bootstrap_values(
                policy_states, rollout_state)

        with profile("Finalize Rollouts"):
            rollout_data, metrics, user_state = self._finalize_rollouts(
                value_normalizer, value_normalizer_state, store,
                rnn_start_states, bootstrap_values, metrics, user_state,
                user_finish_rollouts_hook, user_metrics_hook,
                axis_name=axis_name)

        return (user_state, rollout_state, rollout_data,
                cb_state["obs_stats"], metrics)

    def _bootstrap_values(self, policy_states, rollout_state):
        rnn_states, obs = self._sim_to_train(
            (rollout_state.rnn_states, rollout_state.cur_obs),
            rollout_state.reorder_state)

        train_policy_states = jax.tree.map(
            lambda x: x[0:self._num_train_policies], policy_states)

        @jax.vmap
        def critic_fn(state, rnn_states, obs):
            preprocessed = state.obs_preprocess.preprocess(
                state.obs_preprocess_state, obs, False)
            policy_out, _ = state.apply_fn(
                {"params": state.params, "batch_stats": state.batch_stats},
                rnn_states,
                preprocessed,
                train=False,
                method="critic_only",
            )
            return self._compute_value_estimate(policy_out["critic"])

        return critic_fn(train_policy_states, rnn_states, obs)

    def _finalize_rollouts(self, value_normalizer, value_normalizer_state,
                           rollouts, rnn_start_states,
                           bootstrap_values, metrics, user_state,
                           user_finish_rollouts_hook, user_metrics_hook,
                           axis_name=None):
        if value_normalizer is None:
            unnormalized_values = rollouts["values"]
            unnormalized_bootstrap = bootstrap_values
        else:
            def invert(vn_state, v):
                return value_normalizer.invert(vn_state, v)

            unnormalized_values = jax.vmap(
                invert, in_axes=(0, 2), out_axes=2)(
                    value_normalizer_state, rollouts["values"])
            unnormalized_bootstrap = jax.vmap(invert)(
                value_normalizer_state, bootstrap_values)

        rollouts, user_state = user_finish_rollouts_hook(
            rollouts, bootstrap_values, unnormalized_values,
            unnormalized_bootstrap, user_state)

        if self._use_advantages:
            advantages = compute_advantages(
                self._gamma, self._gae_lambda,
                rollouts["rewards"], unnormalized_values,
                rollouts["dones"], unnormalized_bootstrap)
            returns = advantages + unnormalized_values
            rollouts = rollouts.copy({
                "advantages": advantages.astype(self._cfg.prob_dtype),
                "returns": returns,
            })
        else:
            returns = compute_returns(
                self._gamma, rollouts["rewards"], rollouts["dones"],
                unnormalized_bootstrap)
            rollouts = rollouts.copy({"returns": returns})

        # [C, T/C, P, B, ...] -> [P, B*C, T/C, ...]: each (chunk, agent) pair
        # becomes one training sequence of length T/C. Rows are B-MAJOR
        # (row = b*C + c; the reference uses c-major, reference:
        # rollouts.py:788-804 — same sequence set, permuted rows): the
        # train-agent axis is the one a data-sharded emission layout would
        # shard, so b-major keeps every data shard's rows CONTIGUOUS and
        # the reshape into the learn region's row axis merges a sharded
        # major axis with a replicated minor one — groundwork for the
        # shard-balanced matchmaking layout (TODO.md) that makes the
        # sim->train emission collective-free.
        def reorder_seq_data(x):
            t = x.transpose(2, 3, 0, 1, *range(4, x.ndim))
            return t.reshape(t.shape[0], -1, *t.shape[3:])

        rollouts = jax.tree.map(reorder_seq_data, rollouts)

        # [C, P, B, ...] -> [P, B*C, ...] (b-major, matching the rows above)
        def reorder_rnn_data(x):
            t = x.transpose(1, 2, 0, *range(3, x.ndim))
            return t.reshape(t.shape[0], -1, *t.shape[3:])

        rnn_start_states = jax.tree.map(reorder_rnn_data, rnn_start_states)

        metrics = metrics.record({
            "Rewards": rollouts["rewards"],
            "Values": reorder_seq_data(unnormalized_values),
            "Est Returns": rollouts["returns"],
            "Bootstrap Values": unnormalized_bootstrap,
        }, axis_name=axis_name)
        if self._use_advantages:
            metrics = metrics.record({"Advantages": rollouts["advantages"]},
                                     axis_name=axis_name)

        metrics = user_metrics_hook(metrics, rollouts, user_state)

        return RolloutData(
            data=rollouts.copy({"rnn_start_states": rnn_start_states}),
            num_train_seqs_per_policy=self._num_train_seqs_per_policy,
            num_train_policies=self._num_train_policies,
        ), metrics, user_state


# ---------------------------------------------------------------------------
# Train-ordering index math
# ---------------------------------------------------------------------------

def _compute_num_train_agents_per_policy(rollout_cfg: RolloutConfig):
    pbt = rollout_cfg.pbt
    assert pbt.cross_play_batch_size % pbt.num_teams == 0
    assert pbt.past_play_batch_size % pbt.num_teams == 0

    # Only team 0 generates training data in cross/past play, keeping the
    # per-policy training batch static.
    total = (
        pbt.self_play_batch_size
        + pbt.cross_play_batch_size // pbt.num_teams
        + pbt.past_play_batch_size // pbt.num_teams
    )
    assert total % pbt.num_current_policies == 0
    return total // pbt.num_current_policies


def _compute_sim_to_train_indices(rollout_cfg: RolloutConfig):
    """Gather indices selecting each policy's training agents out of sim
    order.

    Flat layout (``pbt.num_data_shards == 1``): GLOBAL indices
    ``[num_train_policies, num_train_agents_per_policy]``.

    Shard-major layout (``num_data_shards > 1``): SHARD-LOCAL indices
    ``[num_train_policies, num_train_agents_per_policy / D]`` into one
    contiguous shard block of ``sim_batch_size / D`` rows. The layout
    repeats identically per block (only the random opponent draws differ,
    and those never change which rows are team 0), so one local index set
    serves every shard; RolloutManager applies it as a vmapped gather over
    the explicit shard axis, which GSPMD partitions with zero collectives
    (same construction as ops/reorder.py's shard-local chunk layout).
    """
    pbt = rollout_cfg.pbt.shard_view()
    batch_local = rollout_cfg.sim_batch_size // rollout_cfg.pbt.num_data_shards
    local_indices = jnp.arange(batch_local)

    def match_indices(start, stop):
        return local_indices[start:stop].reshape(
            pbt.num_current_policies, -1, pbt.num_teams, pbt.team_size)

    self_end = pbt.self_play_batch_size
    cross_end = self_end + pbt.cross_play_batch_size
    past_end = cross_end + pbt.past_play_batch_size

    self_play = match_indices(0, self_end).reshape(
        pbt.num_current_policies, -1)
    cross_play = match_indices(self_end, cross_end)[:, :, 0, :].reshape(
        pbt.num_current_policies, -1)
    past_play = match_indices(cross_end, past_end)[:, :, 0, :].reshape(
        pbt.num_current_policies, -1)

    return jnp.concatenate([self_play, cross_play, past_play], axis=1)
