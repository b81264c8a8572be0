"""Experimental proposals. Counterpart of
``nessai_tpu/experimental/proposal``."""

from .clustering import ClusteringFlowProposal
from .mcmc import MCMCFlowProposal

__all__ = ["MCMCFlowProposal", "ClusteringFlowProposal"]
