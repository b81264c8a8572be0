"""Flow-based proposals. Counterpart of
``nessai_tpu/proposal/flowproposal``."""

from .base import BaseFlowProposal
from .flowproposal import FlowProposal
from .truncation import (
    TRUNCATION_REGISTRY,
    LatentRadiusTruncation,
    LikelihoodThresholdTruncation,
    MinLogQTruncation,
    TruncationScheme,
)

__all__ = [
    "BaseFlowProposal",
    "FlowProposal",
    "TruncationScheme",
    "LatentRadiusTruncation",
    "MinLogQTruncation",
    "LikelihoodThresholdTruncation",
    "TRUNCATION_REGISTRY",
]
