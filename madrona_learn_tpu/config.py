"""Configuration dataclasses for the trainer.

Capability parity with the reference config surface (reference: cfg.py:9-142):
action-space configs, PBT population config with hyperparameter search spaces,
the main ``TrainConfig``, and ``EvalConfig``. Re-designed for a mesh-first
runtime: ``TrainConfig.mesh`` describes the device mesh the whole train step is
sharded over (absent in the single-GPU reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import jax.numpy as jnp

from .struct import FrozenDict


@dataclass(frozen=True)
class DiscreteActionsConfig:
    """Multi-head categorical action space (reference: cfg.py:9-10)."""

    actions_num_buckets: List[int]


@dataclass(frozen=True)
class ContinuousActionsConfig:
    """Tanh-mean / sigmoid-ranged-std normal action space (reference: cfg.py:13-16)."""

    stddev_min: float
    stddev_max: float
    num_dims: int


ActionsConfig = Union[DiscreteActionsConfig, ContinuousActionsConfig]


class AlgoConfig:
    """Base class for algorithm configs (reference: cfg.py:19-24)."""

    def name(self) -> str:
        raise NotImplementedError

    def setup(self):
        raise NotImplementedError


@dataclass(frozen=True)
class ParamExplore:
    """PBT hyperparameter search space for one scalar (reference: cfg.py:27-45).

    ``base * [min_scale, max_scale]`` is the resample range; sampling happens in
    linear, log10 or ln space. Perturbation multiplies by U[perturb_rnd_min,
    perturb_rnd_max], optionally clipped back to the range.
    """

    base: float
    min_scale: float
    max_scale: float
    log10_scale: bool = False
    ln_scale: bool = False
    clip_perturb: bool = False
    perturb_rnd_min: float = 0.8
    perturb_rnd_max: float = 1.2

    def __repr__(self):
        if self.log10_scale:
            space = "log10"
        elif self.ln_scale:
            space = "ln"
        else:
            space = "linear"
        return (
            f"ParamExplore({self.base * self.min_scale:g}.."
            f"{self.base * self.max_scale:g}, {space}, "
            f"perturb=[{self.perturb_rnd_min}, {self.perturb_rnd_max}])"
        )


@dataclass(frozen=True)
class PBTConfig:
    """Population-based-training config (reference: cfg.py:49-65).

    ``self/cross/past_play_portion`` must sum to 1 and each carve out a slice of
    the sim batch that is divisible by a whole number of matches.
    """

    num_teams: int
    team_size: int
    num_train_policies: int
    num_past_policies: int
    self_play_portion: float
    cross_play_portion: float
    past_play_portion: float
    # A copy (cull or past-snapshot) only happens if the source policy's
    # expected winrate over the destination exceeds this threshold.
    policy_overwrite_threshold: float = 0.7
    reward_hyper_params_explore: Dict[str, ParamExplore] = FrozenDict({})
    # Speed/memory knob: force the rollout policy-chunk size.
    rollout_policy_chunk_size_override: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh for the whole resident train step.

    ``data`` shards the sim batch (env/agent instances); ``policy`` shards the
    PBT population (and its optimizer state); ``model`` optionally tensor-
    shards wide Dense kernels (hidden dim) for large policies — RL policy
    nets are usually small enough to replicate, so it defaults to 1.
    ``data * policy * model`` must equal the number of participating devices.
    The degenerate (1, 1, 1) mesh reproduces the reference's single-device
    behavior.
    """

    data: int = 1
    policy: int = 1
    model: int = 1
    # Run the learn phase as a manual shard_map region (data+policy axes)
    # instead of GSPMD. Semantics are identical (global minibatch
    # composition; losses/gradients pmean over data), but each data shard
    # selects its stratified minibatch rows locally, so the rollout store
    # is never replicated over ``data``. fp16 dynamic loss
    # scaling and advantage filtering / importance sampling are supported
    # inside the region, and so is model-axis TP (the region folds the
    # model axis into the minibatch row split — recurrent-sequence TP
    # would place a collective inside every time step — while rollout
    # inference keeps the wide matmuls genuinely model-sharded under
    # GSPMD). Non-dividing population / minibatch sizes are handled too
    # (weight-0 row padding with psum(sum)/psum(count) reductions), so
    # every configuration is served; manual_learn=False is the explicit
    # escape hatch back to the GSPMD learn path. MEMORY note for the TP fold: inside the learn region
    # params are gathered over ``model`` (each device holds a full
    # parameter + optimizer-state copy of its policy shard during the
    # learn phase), so model>1 does NOT reduce learn-phase param memory;
    # for models too wide for that, set manual_learn=False to get
    # memory-level GSPMD tensor parallelism. See docs/scaling.md
    # "The TP fold".
    manual_learn: bool = True
    # Run the collect phase as a manual shard_map region over ``data``
    # (round 5): the collect-phase communication is exactly
    # the explicit reductions (per-step obs-EMA moments + end-of-collect
    # metric merges — a few hundred bytes over ``data``). Auto-falls back
    # to GSPMD collect when the sim is not data-parallel (host-callback /
    # FFI sims can't run under shard_map), when model > 1 (preserving
    # GSPMD's inference tensor parallelism for wide models), or when the
    # batch does not slice cleanly
    # (rollouts.RolloutManager._manual_collect_enabled).
    manual_collect: bool = True
    # ZeRO-1 style optimizer-state sharding inside the manual learn region
    # (round 5): the Adam moments (mu/nu — 2/3 of optimizer memory, 2x the
    # param bytes in fp32) live sharded over the region's replica axes
    # (``data`` x ``model``) instead of replicated. Each replica reduces
    # its gradient chunk (psum_scatter — the same bytes the replicated
    # path's gradient pmean already moved), runs the clip+Adam math on the
    # chunk, and all_gathers the assembled update; the math is
    # element-for-element identical (equality-tested against the
    # replicated path, tests/test_sharding.py). Lifts the learn-phase
    # per-device memory ceiling of the TP fold from params + 2x moments
    # replicated to params + 2x/R: at reference model scales irrelevant,
    # for wide models it is the memory-level learn-phase parallelism the
    # fold alone does not provide. Opt-in; requires the manual learn
    # region (it is a no-op under GSPMD or on single-device meshes).
    # NOTE the optimizer-state checkpoint layout changes with this flag
    # (moments store as [R, ceil(size/R)] chunks), so checkpoints do not
    # roundtrip across a flag flip.
    zero_opt_state: bool = False

    @property
    def num_devices(self) -> int:
        return self.data * self.policy * self.model

    @property
    def zero_rows(self) -> int:
        """Replica-group size the Adam moments shard over (1 = disabled).

        Active only when the manual learn region runs (same gate as
        train._manual_learn_enabled) and there is more than one replica of
        each policy shard (data * model > 1).
        """
        if not (self.zero_opt_state and self.manual_learn
                and self.num_devices > 1 and self.data * self.model > 1):
            return 1
        return self.data * self.model


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config (reference: cfg.py:68-127)."""

    num_worlds: int
    num_agents_per_world: int
    num_updates: int
    actions: Dict[str, ActionsConfig]
    steps_per_update: int
    lr: Union[float, ParamExplore]
    algo: AlgoConfig
    num_bptt_chunks: int
    gamma: float
    seed: int
    metrics_buffer_size: int
    baseline_policy_id: int = 0
    custom_policy_ids: List[int] = field(default_factory=list)
    gae_lambda: float = 1.0
    pbt: Optional[PBTConfig] = None
    mesh: MeshConfig = MeshConfig()
    dreamer_v3_critic: bool = True
    hlgauss_critic: bool = False
    compute_advantages: bool = True
    normalize_advantages: bool = True  # only if compute_advantages
    normalize_returns: bool = True  # only if not compute_advantages
    normalize_values: bool = False
    filter_advantages: bool = False
    importance_sample_trajectories: bool = False
    importance_sample_num_minibatches: int = 0
    value_normalizer_decay: float = 0.99999
    max_advantage_est_decay: float = 0.99999
    compute_dtype: jnp.dtype = jnp.float32
    # Uniform-mode minibatch composition: the per-policy training sequences
    # are split into this many equal contiguous blocks and every minibatch
    # draws an equal slice from an independent per-block shuffle (stratified
    # sampling; each epoch still visits every sequence exactly once).
    # None = the mesh's data-axis size (so each data shard selects its
    # minibatch rows shard-locally with ZERO collectives inside the manual
    # learn region), which is 1 — today's single global shuffle, the
    # reference's semantics (reference: ppo.py:436-443) — without a
    # multi-device mesh. Pin an explicit value to make minibatch
    # composition (and hence learning curves) independent of deployment
    # mesh size; the zero-collective learn path needs it divisible by
    # mesh.data. Ignored by advantage filtering / importance sampling
    # (their selections are intrinsically global).
    minibatch_stratify: Optional[int] = None

    @property
    def sim_batch_size(self) -> int:
        return self.num_worlds * self.num_agents_per_world

    def __repr__(self):
        rep = ["TrainConfig:"]
        for k, v in self.__dict__.items():
            if k == "algo":
                rep.append(f"  {v.name()}:")
                for ak, av in self.algo.__dict__.items():
                    rep.append(f"    {ak}: {av}")
            elif k == "pbt":
                if v is None:
                    rep.append("  pbt: Disabled")
                else:
                    rep.append("  pbt:")
                    for pk, pv in self.pbt.__dict__.items():
                        rep.append(f"    {pk}: {pv}")
            elif k == "compute_dtype":
                names = {
                    jnp.float32: "fp32",
                    jnp.float16: "fp16",
                    jnp.bfloat16: "bf16",
                }
                rep.append(f"  compute_dtype: {names.get(v, str(v))}")
            else:
                rep.append(f"  {k}: {v}")
        return "\n".join(rep)


@dataclass(frozen=True)
class EvalConfig:
    """Offline evaluation config (reference: cfg.py:130-142)."""

    num_worlds: int
    num_teams: int
    team_size: int
    num_eval_steps: int
    actions: Dict[str, ActionsConfig]
    reward_gamma: float
    policy_dtype: jnp.dtype
    eval_competitive: bool
    use_deterministic_policy: bool = True
    clear_fitness: bool = True
    custom_policy_ids: List[int] = field(default_factory=list)
