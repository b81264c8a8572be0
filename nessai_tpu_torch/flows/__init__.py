"""Normalising flows as ``nn.Module``s. Counterpart of
``nessai_tpu/flows``."""

from .base import Flow
from .bijectors import ActNorm, AffineCoupling, Chain, Permutation, RQSCoupling
from .convert import params_from_jax, params_to_jax
from .distributions import StandardNormal
from .nsf import build_nsf_bijector
from .realnvp import build_realnvp_bijector
from .rqs import rational_quadratic_spline
from .utils import configure_model, get_flow_builder, get_n_neurons

__all__ = [
    "Flow",
    "Chain",
    "AffineCoupling",
    "RQSCoupling",
    "Permutation",
    "ActNorm",
    "StandardNormal",
    "configure_model",
    "get_flow_builder",
    "build_realnvp_bijector",
    "build_nsf_bijector",
    "rational_quadratic_spline",
    "get_n_neurons",
    "params_from_jax",
    "params_to_jax",
]
