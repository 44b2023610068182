"""Device mesh + sharding rules for the resident train step.

This is the multi-device layer the single-device reference does not have
(reference: train.py:144 pins one device; no pmap/pjit/psum exists anywhere
in it — SURVEY.md section 2c). Design:

- One ``jax.sharding.Mesh`` with axes ``("data", "policy")``.
- The **sim batch** (env/agent instances — every rollout-state leaf whose
  leading axis is ``sim_batch_size``) shards over ``data``. A pure-JAX env
  therefore shards for free; per-step obs normalization statistics and metric
  reductions become psums XLA inserts automatically.
- The **population** (policy/train-state leaves whose leading axis is the
  policy count) shards over ``policy``: per-policy PPO updates run as a
  sharded vmap, so optimizer state and Adam moments are distributed; PBT
  cull/past copies lower to cross-shard collective permutes.
- Everything else (metrics ring buffer, PRNG keys, scalar counters)
  replicates.

``shard_training_manager`` device_puts a freshly initialized TrainingManager
according to these rules; jit then propagates the shardings through the
update step. On multi-host deployments call ``jax.distributed.initialize``
first and pass the global device list to ``make_mesh``; shardings are
expressed in global terms so the same code runs on a pod slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MeshConfig

DATA_AXIS = "data"
POLICY_AXIS = "policy"
MODEL_AXIS = "model"


def make_mesh(mesh_cfg: MeshConfig,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= mesh_cfg.num_devices, (
        f"mesh {mesh_cfg} needs {mesh_cfg.num_devices} devices, "
        f"have {len(devices)}")
    grid = np.asarray(devices[:mesh_cfg.num_devices]).reshape(
        mesh_cfg.data, mesh_cfg.policy, mesh_cfg.model)
    return Mesh(grid, (DATA_AXIS, POLICY_AXIS, MODEL_AXIS))


def shard_params_for_tp(params, mesh: Mesh, min_dim: int = 256,
                        stacked_policy_axis: bool = True):
    """Tensor-parallel sharding rules for Dense kernels (GSPMD style).

    Kernels whose output feature dim is >= ``min_dim`` and divisible by the
    ``model`` axis size are sharded along that dim; XLA then partitions the
    matmuls and inserts the reduce-scatters/all-gathers. Everything else
    replicates over ``model``. With ``stacked_policy_axis`` the leading
    population axis additionally shards over ``policy``.

    RL policies are typically small (TP is a documented non-goal of the
    reference — SURVEY.md section 2c); this exists so wide policies scale
    without code changes: ``params = device_put(params,
    shard_params_for_tp(params, mesh))``.
    """
    n_model = mesh.shape[MODEL_AXIS]
    n_policy = mesh.shape[POLICY_AXIS]

    def rule(path, leaf):
        if not hasattr(leaf, "ndim"):
            return NamedSharding(mesh, P())
        lead = (POLICY_AXIS,) if (
            stacked_policy_axis
            and leaf.ndim >= 1
            and leaf.shape[0] % max(n_policy, 1) == 0
            and n_policy > 1
        ) else (None,)

        # Paths mix dict keys (params FrozenDicts, .key) and dataclass
        # attribute keys (.name) when applied to whole policy-state trees.
        last = path[-1] if path else None
        last_name = getattr(last, "key", getattr(last, "name", None))
        is_kernel = last_name == "kernel" and leaf.ndim >= 2
        if (
            is_kernel
            and leaf.shape[-1] >= min_dim
            and leaf.shape[-1] % n_model == 0
            and n_model > 1
        ):
            spec = lead + (None,) * (leaf.ndim - len(lead) - 1) + (MODEL_AXIS,)
            return NamedSharding(mesh, P(*spec))

        if lead != (None,):
            spec = lead + (None,) * (leaf.ndim - 1)
            return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(rule, params)


def replicate_for_inference(tree, mesh_cfg: Optional[MeshConfig]):
    """Pin ``tree`` (a stacked policy-state pytree) replicated over the mesh.

    The rollout loop's per-chunk weight gather (``x[state_idxs]`` over the
    policy-sharded population) otherwise lowers to an all-reduce of
    [num_chunks x full param struct] over the ``policy`` axis EVERY sim
    step — 44.85 GB per device per update at the weak-scaled config-#5
    shape, counted from the compiled program's collectives: 97% of all
    communication in the step. Replicating the *inference copy* once per
    update turns that into one population all-gather ((P-1)/P x population
    params, ~2 orders of magnitude less traffic) and makes every
    subsequent per-step chunk gather shard-local. Optimizer state and the
    learn phase keep the population sharded over ``policy``; this touches
    only the read-only copy the rollout/eval loops consume.

    With ``model > 1`` the wide Dense kernels KEEP their model-axis
    tensor-parallel sharding (same rules as ``shard_params_for_tp`` with
    the population axis replicated) so GSPMD still partitions the
    inference matmuls over ``model``; only data/policy replicate.

    No-op without a multi-device mesh or when already replicated.
    """
    if mesh_cfg is None or mesh_cfg.num_devices <= 1:
        return tree
    mesh = make_mesh(mesh_cfg)
    if mesh_cfg.model > 1:
        shardings = shard_params_for_tp(
            tree, mesh, stacked_policy_axis=False)
        return jax.tree.map(
            lambda x, s: jax.lax.with_sharding_constraint(x, s)
            if isinstance(x, jax.Array) else x,
            tree, shardings)
    rep = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, rep)
        if isinstance(x, jax.Array) else x,
        tree)


def _shard_by_leading_axis(tree, mesh: Mesh, axis_sizes, axis_name):
    """NamedShardings sharding axis 0 over ``axis_name`` for leaves whose
    leading dim is in ``axis_sizes`` and divisible by the mesh axis; replicate
    the rest."""
    n_shards = mesh.shape[axis_name]
    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(axis_name))

    def rule(leaf):
        if (
            hasattr(leaf, "ndim")
            and leaf.ndim >= 1
            and leaf.shape[0] in axis_sizes
            and leaf.shape[0] % n_shards == 0
        ):
            return sharded
        return replicated

    return jax.tree.map(rule, tree)


def training_manager_shardings(training_mgr, mesh: Mesh):
    """A TrainingManager-shaped pytree of NamedShardings."""
    rollout = training_mgr.rollout
    state = training_mgr.state

    sim_batch = rollout.cfg.sim_batch_size
    num_worlds = rollout.cfg.num_worlds
    pbt = rollout.cfg.pbt
    policy_counts = {pbt.total_num_policies, pbt.num_current_policies}

    rollout_shardings = _shard_by_leading_axis(
        rollout, mesh, {sim_batch, num_worlds}, DATA_AXIS)
    state_shardings = _shard_by_leading_axis(
        state, mesh, policy_counts, POLICY_AXIS)

    mesh_cfg = getattr(rollout.cfg, "mesh", None)
    if mesh_cfg is not None and mesh_cfg.zero_rows > 1:
        # ZeRO optimizer-state sharding (MeshConfig.zero_opt_state): the
        # chunked Adam moment leaves [P, R, chunk] additionally shard
        # their chunk axis over the learn region's replica axes, so the
        # 1/R per-device moment memory holds from initial placement, not
        # just after the first update's out_specs pin it.
        from ..train_state import map_adam_moments

        row_axes = ((DATA_AXIS, MODEL_AXIS) if mesh_cfg.model > 1
                    else DATA_AXIS)
        zero_sharding = NamedSharding(mesh, P(POLICY_AXIS, row_axes))
        state_shardings = state_shardings.replace(
            train_states=state_shardings.train_states.replace(
                opt_state=map_adam_moments(
                    state_shardings.train_states.opt_state,
                    lambda sub: jax.tree.map(
                        lambda _: zero_sharding, sub))))
    metrics_shardings = jax.tree.map(
        lambda _: NamedSharding(mesh, P()), training_mgr.metrics)

    return training_mgr.replace(
        rollout=rollout_shardings,
        state=state_shardings,
        metrics=metrics_shardings,
        update_idx=NamedSharding(mesh, P()),
    )


def _place_global(x, sharding):
    """Place one (host-replicated) leaf onto a possibly multi-process
    sharding.

    Single-process: plain ``device_put``. Multi-process: ``device_put``
    rejects shardings with non-addressable devices, so build the global
    array from each process's local view with ``make_array_from_callback``
    — every process computed the identical full value during init (SPMD), so
    slicing the local copy yields consistent global shards. PRNG-key arrays
    are unwrapped to their uint32 key data and rewrapped (extended dtypes
    can't round-trip through numpy)."""
    if x is None or not hasattr(x, "shape"):
        return x
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)

    if isinstance(x, jax.Array) and jnp.issubdtype(
            x.dtype, jax.dtypes.prng_key):
        impl = jax.random.key_impl(x)
        data = np.asarray(jax.device_get(jax.random.key_data(x)))
        placed = jax.make_array_from_callback(
            data.shape, sharding, lambda idx: data[idx])
        return jax.random.wrap_key_data(placed, impl=impl)

    host = np.asarray(jax.device_get(x))
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx])


def shard_training_manager(training_mgr, mesh: Mesh):
    """Place a TrainingManager across the mesh per the sharding rules.

    Multi-host safe: call from every process after ``init_training`` (each
    process initializes the identical state; leaves become global sharded
    arrays)."""
    shardings = training_manager_shardings(training_mgr, mesh)
    return jax.tree.map(
        _place_global,
        training_mgr, shardings,
        is_leaf=lambda x: x is None,
    )
