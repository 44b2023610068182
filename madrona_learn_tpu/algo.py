"""Algorithm base interface + shared hyperparameters.

Capability parity with the reference algorithm abstraction (reference:
algo_common.py:15-42). The advantage/return math lives in ``ops.gae``.
"""

from __future__ import annotations

from .config import TrainConfig
from .struct import FrozenDict, PyTreeNode


class HyperParams(PyTreeNode):
    """Per-policy hyperparameters kept on-device so PBT can mutate them."""

    lr: float
    gamma: float
    gae_lambda: float
    normalize_values: bool
    value_normalizer_decay: float
    max_advantage_est_decay: float


class AlgoBase:
    def init_hyperparams(self, cfg: TrainConfig) -> HyperParams:
        raise NotImplementedError

    def make_optimizer(self, hyper_params: HyperParams):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def add_metrics(self, cfg: TrainConfig, metrics: FrozenDict):
        raise NotImplementedError
