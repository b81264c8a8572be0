"""Flow training and inference. Counterpart of ``nessai_tpu/flowmodel``."""

from .base import FlowModel
from .importance import ImportanceFlowModel
from .config import (
    FlowConfig,
    TrainingConfig,
    update_flow_config,
    update_training_config,
)

__all__ = [
    "FlowModel",
    "ImportanceFlowModel",
    "FlowConfig",
    "TrainingConfig",
    "update_flow_config",
    "update_training_config",
]
