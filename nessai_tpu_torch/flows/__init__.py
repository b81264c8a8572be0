"""Normalising flows as ``nn.Module``s. Counterpart of
``nessai_tpu/flows``."""

from .base import Flow
from .bijectors import ActNorm, AffineCoupling, Chain, Permutation
from .convert import params_from_jax, params_to_jax
from .distributions import StandardNormal
from .utils import configure_model, get_n_neurons

__all__ = [
    "Flow",
    "Chain",
    "AffineCoupling",
    "Permutation",
    "ActNorm",
    "StandardNormal",
    "configure_model",
    "get_n_neurons",
    "params_from_jax",
    "params_to_jax",
]
