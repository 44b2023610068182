"""madrona_learn_tpu: an on-device RL training framework in JAX.

Brand-new implementation with the capabilities of madrona-learn (studied in
SURVEY.md): fully on-device PPO over batched simulators with recurrent /
attention actor-critics, GAE, EMA normalization, distributional critics, and
population-based training — designed mesh-first, from one GPU to many.
"""

from .config import (
    DiscreteActionsConfig,
    ContinuousActionsConfig,
    TrainConfig,
    PBTConfig,
    MeshConfig,
    ParamExplore,
    EvalConfig,
)
from .ops import (
    DiscreteActionDistributions,
    ContinuousActionDistributions,
    EMAEstimate,
    EMANormalizer,
    Metric,
    TrainingMetrics,
)
from .models import (
    ActorCritic,
    Backbone,
    BackboneEncoder,
    RecurrentBackboneEncoder,
    BackboneShared,
    BackboneSeparate,
)
from .utils import profile, aot_compile, cfg_jax_mem
from .observations import (
    ObservationsPreprocess,
    ObservationsEMANormalizer,
    ObservationsCaster,
    ObservationsPreprocessNoop,
)
from .policy import Policy
from .ppo import PPOConfig
from .train import (
    init_training,
    stop_training,
    join_warmup_threads,
    eval_elo,
    eval_elo_warmup,
    update_population,
    latest_checkpoint,
    TrainingManager,
    TrainHooks,
)
from .train_state import TrainStateManager, wait_for_checkpoints
from .eval import eval_load_ckpt, eval_policies
from .rollouts import (
    RolloutConfig,
    RolloutState,
    RolloutManager,
    RolloutData,
    rollout_loop,
    rollouts_reset,
)
from .pbt import (
    PBTMatchmakeConfig,
    pbt_init_matchmaking,
    pbt_update_matchmaking,
    pbt_update_elo,
    pbt_update_fitness,
    pbt_explore_hyperparams,
    pbt_cull_update,
    pbt_past_update,
)
from . import models, ops, envs, parallel
from .utils.tensorboard import TensorboardWriter

try:
    from .utils.wandb import WandbWriter  # noqa: F401
    _HAVE_WANDB = True
except ImportError:
    _HAVE_WANDB = False

__version__ = "0.1.0"

__all__ = [
    "DiscreteActionsConfig",
    "ContinuousActionsConfig",
    "TrainConfig",
    "PBTConfig",
    "MeshConfig",
    "ParamExplore",
    "EvalConfig",
    "DiscreteActionDistributions",
    "ContinuousActionDistributions",
    "EMAEstimate",
    "EMANormalizer",
    "Metric",
    "TrainingMetrics",
    "ActorCritic",
    "Backbone",
    "BackboneEncoder",
    "RecurrentBackboneEncoder",
    "BackboneShared",
    "BackboneSeparate",
    "profile",
    "aot_compile",
    "cfg_jax_mem",
    "ObservationsPreprocess",
    "ObservationsEMANormalizer",
    "ObservationsCaster",
    "ObservationsPreprocessNoop",
    "Policy",
    "PPOConfig",
    "init_training",
    "stop_training",
    "join_warmup_threads",
    "eval_elo",
    "eval_elo_warmup",
    "update_population",
    "TrainingManager",
    "TrainHooks",
    "TrainStateManager",
    "wait_for_checkpoints",
    "eval_load_ckpt",
    "eval_policies",
    "TensorboardWriter",
    "WandbWriter",
]
