"""Sim-order <-> policy-chunk-order batch reordering.

During PBT rollouts every sim agent slot carries a policy assignment that can
change each step (matchmaking). Policy inference wants each policy's agents
batched contiguously so one vmap over fixed-size chunks serves the whole
population. This module computes, entirely with static shapes, the gather
index sets that move data between:

- **sim order**: the flat ``[sim_batch_size]`` layout the simulator sees, and
- **policy order**: ``[num_chunks, chunk_size]`` where each chunk holds agents
  of exactly one policy (chunks are padded; a policy can own several chunks).

Capability parity with the reference reorder machinery (reference:
rollouts.py:137-168, 1107-1211), with a simpler construction: per-policy
counts come from a ``bincount`` rather than sorted-run transition detection,
which both reads better and avoids the scatter-with-OOB-sentinel dance.

Packing scheme (identical guarantees to the reference): sort agents by
assignment; each policy first fills ``floor(count/C)`` full chunks, packed
densely from the front of the chunk array; each policy then owns exactly one
reserved partial chunk at slot ``num_full_chunks_total + policy``. Worst case
``B = ceil(N/C) + P - 1`` chunks, so the layout is static for any assignment
pattern.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..struct import PyTreeNode, field


def compute_reorder_chunks(assignments: jax.Array, P: int, C: int, B: int):
    """Build gather indices for policy-chunked batching.

    Args:
      assignments: ``[N]`` int array of policy ids in ``[0, P)``.
      P: total number of policies.
      C: chunk size (agents per policy chunk).
      B: total number of chunks (must be >= ``ceil(N/C) + P - 1``).

    Returns:
      ``(to_policy_idxs [B, C], to_sim_idxs [N])``. ``to_policy_idxs`` gathers
      sim-order data into chunk layout; empty slots point at the chunk's first
      element (so a chunk only ever gathers its own policy's data), and fully
      empty chunks hold the OOB sentinel ``N`` (resolved by clip-mode gathers).
      ``to_sim_idxs`` gathers the flattened ``[B*C]`` chunk layout back to sim
      order.
    """
    assert assignments.ndim == 1
    N = assignments.shape[0]

    if P <= 64:
        # Counting sort: a [N, P] one-hot cumsum gives each agent's rank
        # within its policy directly — no argsort (the per-step reorder is
        # on the rollout hot path); the O(N*P) cumsum suits up to moderate
        # population sizes.
        one_hot = (
            assignments[:, None]
            == jnp.arange(P, dtype=assignments.dtype)[None, :])
        counts = jnp.sum(one_hot, axis=0)
        ranks_all = jnp.cumsum(one_hot.astype(jnp.int32), axis=0) - 1
        offsets = jnp.sum(jnp.where(one_hot, ranks_all, 0), axis=1)
        owner = assignments
        src_idxs = None  # dest is already indexed by original position
    else:
        sort_idxs = jnp.argsort(assignments)
        owner = assignments[sort_idxs]
        counts = jnp.bincount(assignments, length=P)
        starts = jnp.cumsum(counts) - counts
        offsets = jnp.arange(N, dtype=counts.dtype) - starts[owner]
        src_idxs = sort_idxs

    num_full_chunks = counts // C
    full_counts = num_full_chunks * C
    full_cumsum = jnp.cumsum(full_counts)
    full_starts = full_cumsum - full_counts

    # One reserved partial chunk per policy, after all full chunks.
    partial_base = full_cumsum[-1]
    partial_starts = (
        partial_base + jnp.arange(P, dtype=counts.dtype) * C - full_counts)

    # An item's offset within its policy's run decides whether it lands in a
    # full chunk or the policy's reserved partial chunk.
    in_full = offsets < full_counts[owner]
    dest = jnp.where(
        in_full,
        full_starts[owner] + offsets,
        partial_starts[owner] + offsets,
    ).astype(jnp.int32)

    if src_idxs is None:
        sources = jnp.arange(N, dtype=jnp.int32)
        to_sim_idxs = dest
    else:
        sources = src_idxs.astype(jnp.int32)
        to_sim_idxs = (
            jnp.empty((N,), jnp.int32)
            .at[src_idxs]
            .set(dest, unique_indices=True)
        )

    to_policy_idxs = (
        jnp.full((B * C,), N, jnp.int32)
        .at[dest]
        .set(sources, unique_indices=True)
        .reshape(B, C)
    )
    # Redirect padding slots to the chunk's first (valid) element.
    to_policy_idxs = jnp.where(
        to_policy_idxs != N, to_policy_idxs, to_policy_idxs[:, 0:1])

    return to_policy_idxs, to_sim_idxs


def compute_reorder_chunks_sharded(assignments, P, C, B_local, D):
    """Shard-local variant for a ``data``-sharded sim batch.

    The global construction's one-hot cumsum and gathers span the whole
    batch — under a sharded data axis XLA must insert collectives for them
    every rollout step. Here the batch is split into ``D`` contiguous
    shard blocks; each block gets its own independent chunk layout
    (``B_local = ceil((N/D)/C) + P - 1`` chunks), so every gather index
    stays inside its block and the SPMD partitioner keeps the reorder
    entirely shard-local. Cost: up to ``(D-1)*(P-1)`` extra padded partial
    chunks vs the global layout — the collective-free tradeoff.

    Returns ``(to_policy_idxs [D, B_local, C], to_sim_idxs [D, n_local])``
    in SHARD-LOCAL index space (empty chunks hold the local sentinel
    ``n_local``); apply through ``PolicyBatchReorderState`` with
    ``data_shards=D``.
    """
    if D <= 1:
        raise ValueError(
            "compute_reorder_chunks_sharded requires D > 1; with one data "
            "shard use compute_reorder_chunks (production routes "
            "data_shards=1 there — rollouts.py RolloutConfig.setup)")
    N = assignments.shape[0]
    assert N % D == 0, (N, D)
    n_local = N // D

    to_policy_local, to_sim_local = jax.vmap(
        lambda a: compute_reorder_chunks(a, P, C, B_local)
    )(assignments.reshape(D, n_local))
    # to_policy_local: [D, B_local, C] into the local [n_local] block
    #   (empty chunks hold the local sentinel n_local);
    # to_sim_local: [D, n_local] into the local flat [B_local * C] layout.
    # Indices stay LOCAL: PolicyBatchReorderState applies them as batched
    # (vmapped) gathers over the explicit shard axis, which GSPMD
    # partitions with zero communication — offsetting to global indices
    # would force the partitioner to assume cross-shard access.
    return (to_policy_local.astype(jnp.int32),
            to_sim_local.astype(jnp.int32))


class PolicyBatchReorderState(PyTreeNode):
    """Bidirectional gather state between sim order and policy-chunk order.

    When matchmaking is trivial (pure self-play with a block-constant
    assignment), both index sets are ``None`` and the transforms are free
    reshapes (reference: rollouts.py:143-168).
    """

    to_policy_idxs: Optional[jax.Array]
    to_sim_idxs: Optional[jax.Array]
    policy_dims: Tuple[int, ...] = field(pytree_node=False)
    sim_dims: Tuple[int, ...] = field(pytree_node=False)
    # >1: the index arrays are [D, ...] shard-local (see
    # compute_reorder_chunks_sharded) and transforms run as batched gathers
    # over the explicit shard axis — communication-free under a data-sharded
    # batch.
    data_shards: int = field(pytree_node=False, default=1)

    def to_policy(self, data):
        D = self.data_shards

        def txfm(x):
            if self.to_policy_idxs is None:
                return x.reshape(*self.policy_dims, *x.shape[1:])
            if D == 1:
                # Clip-mode gather resolves the OOB sentinel in empty
                # chunks.
                return x.at[self.to_policy_idxs].get(mode="clip")
            B_local, C = self.to_policy_idxs.shape[1:3]
            x_blocks = x.reshape(D, -1, *x.shape[1:])
            out = jax.vmap(
                lambda xb, ib: xb.at[ib].get(mode="clip")
            )(x_blocks, self.to_policy_idxs)  # [D, B_local, C, ...]
            return out.reshape(D * B_local, C, *x.shape[1:])

        return jax.tree.map(txfm, data)

    def to_sim(self, data):
        D = self.data_shards
        if self.to_policy_idxs is not None:
            if D == 1:
                num_flat = (self.to_policy_idxs.shape[0]
                            * self.to_policy_idxs.shape[1])
            else:
                B_local, C = self.to_policy_idxs.shape[1:3]
                num_flat_local = B_local * C

        def txfm(x):
            if self.to_sim_idxs is None:
                return x.reshape(*self.sim_dims, *x.shape[2:])
            if D == 1:
                flat_chunks = x.reshape(num_flat, *x.shape[2:])
                return flat_chunks.at[self.to_sim_idxs].get(
                    unique_indices=True)
            # x: [D*B_local, C, ...] -> per-shard flat chunk blocks.
            x_blocks = x.reshape(D, num_flat_local, *x.shape[2:])
            out = jax.vmap(
                lambda xb, ib: xb.at[ib].get(unique_indices=True)
            )(x_blocks, self.to_sim_idxs)  # [D, n_local, ...]
            return out.reshape(*self.sim_dims, *x.shape[2:])

        return jax.tree.map(txfm, data)
