"""Flow-based proposals. Counterpart of
``nessai_tpu/proposal/flowproposal``."""

from .base import BaseFlowProposal
from .flowproposal import FlowProposal
from .truncation import LatentRadiusTruncation

__all__ = ["BaseFlowProposal", "FlowProposal", "LatentRadiusTruncation"]
