"""Flow construction. Counterpart of ``nessai_tpu/flows/utils.py``
(``get_n_neurons``, the builder registry, the base distributions by
name, ``create_linear_transform``, ``create_pre_transform``,
``configure_model``, ``reset_weights``, ``reset_permutations``) for the RealNVP, neural-spline
and masked autoregressive families."""

import copy

import torch

from .base import Flow
from .bijectors import ActNorm, Logit, Permutation
from .distributions import MultivariateNormal, MultivariateUniform, ResampledGaussian, StandardNormal
from .maf import build_maf_bijector
from .nsf import build_nsf_bijector
from .realnvp import build_realnvp_bijector, make_linear_transform

__all__ = [
    "get_n_neurons",
    "get_flow_builder",
    "get_base_distribution",
    "create_linear_transform",
    "create_pre_transform",
    "configure_model",
    "reset_weights",
    "reset_permutations",
]

#: ``ftype`` names and their builders (``nessai_tpu/flows/utils.py:42-52``);
#: the glasflow-prefixed names map to the same builders.
_BUILDERS = {
    "realnvp": build_realnvp_bijector,
    "frealnvp": build_realnvp_bijector,
    "spline": build_nsf_bijector,
    "nsf": build_nsf_bijector,
    "rq-nsf": build_nsf_bijector,
    "maf": build_maf_bijector,
    "glasflow-realnvp": build_realnvp_bijector,
    "glasflow-nsf": build_nsf_bijector,
}

#: Config keys forwarded to the builder, as the JAX package's
#: ``configure_model`` does (those the port's builders take).
_BUILDER_KEYS = (
    "mask",
    "net",
    "linear_transform",
    "batch_norm_between_layers",
    "num_bins",
    "tail_bound",
    "tails",
    "pre_transform",
    "volume_preserving",
    "activation",
    "dropout_probability",
)


def get_n_neurons(n_neurons, n_inputs: int) -> int:
    """Resolve the conditioner width: ``None``, ``"auto"`` and
    ``"double"`` are ``2 * n_inputs``, ``"equal"`` is ``n_inputs`` and
    ``"half"`` is ``n_inputs // 2`` (at least 1)."""
    if n_neurons is None or n_neurons in ("auto", "double"):
        return 2 * n_inputs
    if n_neurons == "equal":
        return n_inputs
    if n_neurons == "half":
        return max(n_inputs // 2, 1)
    if isinstance(n_neurons, str):
        raise ValueError(f"Could not get number of neurons: unknown value {n_neurons!r}")
    return int(n_neurons)


def get_flow_builder(ftype: str):
    """The bijector builder registered under ``ftype``."""
    name = ftype.lower()
    if name not in _BUILDERS:
        raise ValueError(f"Unknown flow: {name}. Known flows are: {sorted(_BUILDERS)}")
    return _BUILDERS[name]


def create_linear_transform(linear_transform, features: int, generator=None) -> list:
    """The bijectors of a linear transform between blocks, by name
    (``nessai_tpu/flows/utils.py:98-103``)."""
    return make_linear_transform(linear_transform, features, generator)


def create_pre_transform(pre_transform, features: int, **kwargs):
    """A pre-transform by name: ``"logit"`` (``Logit(**kwargs)``) or
    ``"batch_norm"`` (an :class:`ActNorm`), as
    ``nessai_tpu/flows/utils.py:106-116`` builds them."""
    if pre_transform == "logit":
        return Logit(**kwargs)
    if pre_transform == "batch_norm":
        return ActNorm(features)
    raise ValueError(f"Unknown pre-transform: {pre_transform}")


def get_base_distribution(n_inputs: int, distribution, **kwargs):
    """A base distribution by name, class or instance
    (``nessai_tpu/flows/utils.py:119-134``): a name goes through the
    names of :func:`configure_model`, a class is built with the dimension
    and ``kwargs``, an instance is returned as it is."""
    if distribution is None:
        return _make_base_distribution(None, n_inputs, kwargs or None)
    if isinstance(distribution, str):
        return _make_base_distribution(distribution.lower(), n_inputs, kwargs or None)
    if isinstance(distribution, type):
        return distribution(n_inputs, **kwargs)
    return distribution


def _make_base_distribution(name, dim: int, kwargs, generator=None):
    """``nessai_tpu/flows/utils.py:165-178``: ``None``, ``"normal"`` and
    ``"mvn"`` (a ``var`` other than 1 gives :class:`MultivariateNormal`),
    ``"lars"``/``"resampled"`` (:class:`ResampledGaussian` with
    ``kwargs``) and ``"uniform"`` (the unit box)."""
    if name is None or name == "normal" or name == "mvn":
        var = kwargs.pop("var", 1.0) if isinstance(kwargs, dict) else 1.0
        if var != 1.0:
            return MultivariateNormal(dim, var=var)
        return StandardNormal(dim)
    if name in ("lars", "resampled"):
        return ResampledGaussian(dim, generator=generator, **(kwargs or {}))
    if name == "uniform":
        return MultivariateUniform(dim)
    raise ValueError(f"Unknown distribution: {name}")


def configure_model(config: dict) -> Flow:
    """Build a :class:`Flow` from a flow config dict (keys ``n_inputs,
    n_blocks, n_layers, n_neurons, ftype, distribution,
    distribution_kwargs, kwargs, seed`` and the builder keys). Weights
    and permutations are drawn from a ``torch.Generator`` seeded with
    ``config['seed']`` (default 0), the bijectors' first and then the
    base distribution's. The flow is returned in evaluation mode (no
    dropout)."""
    config = copy.deepcopy(config)
    dim = config.get("n_inputs")
    if not isinstance(dim, int):
        raise TypeError(f"Number of inputs (n_inputs) must be an int, got: {dim}")
    builder = get_flow_builder(config.get("ftype") or "realnvp")
    extra = dict(config.get("kwargs") or {})
    if config.get("context_features") or extra.get("context_features"):
        raise NotImplementedError(
            "context_features: no sampler passes a context, and the port's conditioners "
            "take none yet (ROADMAP §1 item 2, the rest)"
        )
    for k in _BUILDER_KEYS:
        if k in config:
            extra[k] = config[k]
    generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
    bijector = builder(
        dim,
        n_blocks=config.get("n_blocks", 4),
        n_neurons=get_n_neurons(config.get("n_neurons"), n_inputs=dim),
        n_layers=config.get("n_layers", 2),
        generator=generator,
        **extra,
    )
    base = _make_base_distribution(
        config.get("distribution"), dim, config.get("distribution_kwargs"), generator
    )
    return Flow(bijector, base, dim).eval()


@torch.no_grad()
def reset_weights(flow: Flow, config: dict, generator: torch.Generator) -> None:
    """Give ``flow`` (built from ``config``) fresh weights in place, as a
    new flow from ``config`` starts, with its seed drawn from
    ``generator``: every bijector (coupling, linear layer, MADE, ActNorm)
    and the base distribution's parameters (LARS); the permutations keep
    their order (``nessai_tpu/flows/utils.py:reset_weights``)."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    fresh = configure_model(dict(config, seed=seed))
    for b, new in zip(flow.bijector.bijectors, fresh.bijector.bijectors, strict=True):
        if not isinstance(b, Permutation):
            b.load_state_dict(new.state_dict())
    flow.base.load_state_dict(fresh.base.state_dict())


@torch.no_grad()
def reset_permutations(flow: Flow, config: dict, generator: torch.Generator) -> None:
    """Give ``flow`` (built from ``config``) fresh permutations in place,
    those of a new flow from ``config`` with its seed drawn from
    ``generator``; every other weight stays
    (``nessai_tpu/flows/utils.py:reset_permutations``)."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    fresh = configure_model(dict(config, seed=seed))
    for b, new in zip(flow.bijector.bijectors, fresh.bijector.bijectors, strict=True):
        if isinstance(b, Permutation):
            b.load_state_dict(new.state_dict())
