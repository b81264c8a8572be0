"""Latent-space ensemble MCMC proposal. Counterpart of
``nessai_tpu/experimental/proposal/mcmc``."""

from .proposal import MCMCFlowProposal
from .steps import KNOWN_STEPS, DifferentialEvolutionStep, GaussianStep, MCMCStep, Step, StretchStep

__all__ = [
    "MCMCFlowProposal",
    "MCMCStep",
    "Step",
    "GaussianStep",
    "DifferentialEvolutionStep",
    "StretchStep",
    "KNOWN_STEPS",
]
