"""Proposals. Counterpart of ``nessai_tpu/proposal``."""

from .analytic import AnalyticProposal
from .base import Proposal
from .flowproposal import FlowProposal
from .importance import ImportanceFlowProposal
from .rejection import RejectionProposal

__all__ = [
    "AnalyticProposal",
    "Proposal",
    "FlowProposal",
    "ImportanceFlowProposal",
    "RejectionProposal",
]
