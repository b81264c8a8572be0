"""Normalising flows as ``nn.Module``s. Counterpart of
``nessai_tpu/flows``."""

from .base import Flow
from .bijectors import (
    ActNorm,
    AffineCoupling,
    Bijector,
    Chain,
    Logit,
    LULinear,
    MaskedAffineAutoregressive,
    Permutation,
    RQSCoupling,
    SVDLinear,
)
from .convert import params_from_jax, params_to_jax
from .distributions import MultivariateNormal, MultivariateUniform, ResampledGaussian, StandardNormal
from .maf import build_maf_bijector
from .nsf import build_nsf_bijector
from .realnvp import build_realnvp_bijector
from .rqs import rational_quadratic_spline
from .utils import (
    configure_model,
    get_base_distribution,
    get_flow_builder,
    get_flow_class,
    get_n_neurons,
    get_native_flow_class,
    register_flow,
    reset_permutations,
    reset_weights,
)

__all__ = [
    "Flow",
    "Bijector",
    "Chain",
    "AffineCoupling",
    "RQSCoupling",
    "Permutation",
    "ActNorm",
    "LULinear",
    "SVDLinear",
    "Logit",
    "MaskedAffineAutoregressive",
    "StandardNormal",
    "MultivariateNormal",
    "MultivariateUniform",
    "ResampledGaussian",
    "configure_model",
    "get_flow_builder",
    "get_native_flow_class",
    "get_flow_class",
    "register_flow",
    "get_base_distribution",
    "build_realnvp_bijector",
    "build_nsf_bijector",
    "build_maf_bijector",
    "rational_quadratic_spline",
    "get_n_neurons",
    "params_from_jax",
    "params_to_jax",
    "reset_weights",
    "reset_permutations",
]
