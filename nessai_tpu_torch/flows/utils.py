"""Flow construction. Counterpart of ``nessai_tpu/flows/utils.py``
(``get_n_neurons``, the builder registry with ``register_flow``, the base
distributions by name, ``create_linear_transform``,
``create_pre_transform``, ``configure_model``, ``reset_weights``,
``reset_permutations``, ``get_activation_function``) for the RealNVP,
neural-spline and masked autoregressive families, conditional where
``context_features`` is set, and for flows that users register or pass
as the ``flow`` key."""

import copy

import torch

from .base import Flow
from .bijectors import ActNorm, Logit, Permutation
from .distributions import MultivariateNormal, MultivariateUniform, ResampledGaussian, StandardNormal
from .maf import build_maf_bijector
from .nsf import build_nsf_bijector
from .realnvp import build_realnvp_bijector, make_linear_transform

__all__ = [
    "get_activation_function",
    "get_n_neurons",
    "get_flow_builder",
    "get_native_flow_class",
    "get_flow_class",
    "register_flow",
    "get_base_distribution",
    "create_linear_transform",
    "create_pre_transform",
    "configure_model",
    "reset_weights",
    "reset_permutations",
]

def get_activation_function(name: str):
    """The activation function of ``name`` (``relu``, ``tanh``,
    ``silu``/``swish``, ``gelu``, ``sigmoid``)."""
    from .nets import ACTIVATIONS

    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation: {name}")
    return ACTIVATIONS[name]


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
    "context_features",
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


#: the JAX package's names of :func:`get_flow_builder`
#: (``nessai_tpu/flows/utils.py:135-149``)
get_native_flow_class = get_flow_builder
get_flow_class = get_flow_builder


def register_flow(name: str, builder) -> None:
    """Register a flow architecture under an ``ftype`` name
    (``nessai_tpu/flows/utils.py:152-165``).

    ``builder(dim, n_blocks=..., n_neurons=..., n_layers=...,
    generator=..., **kwargs)`` returns a bijector module (``forward(x,
    context=None)`` and ``inverse(z, context=None)``, each giving
    ``(output, log_det)``), which is combined with the configured base
    distribution, or a whole :class:`~nessai_tpu_torch.flows.base.Flow`.
    ``generator`` is the ``torch.Generator`` of the flow's seed; the
    builder may draw its initial weights from it."""
    if not callable(builder):
        raise TypeError("builder must be callable")
    _BUILDERS[name.lower()] = builder


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
    n_blocks, n_layers, n_neurons, ftype, flow, distribution,
    distribution_kwargs, kwargs, seed`` and the builder keys, among them
    ``context_features``: the width of the context that the couplings'
    nets take). A callable ``flow`` is the builder and overrides
    ``ftype`` (see :func:`register_flow`); it may return a whole
    :class:`Flow`. Weights and permutations are drawn from a
    ``torch.Generator`` seeded with ``config['seed']`` (default 0), the
    bijectors' first and then the base distribution's. The flow is
    returned in evaluation mode (no dropout)."""
    config = copy.deepcopy(config)
    dim = config.get("n_inputs")
    if not isinstance(dim, int):
        raise TypeError(f"Number of inputs (n_inputs) must be an int, got: {dim}")
    builder = config.get("flow")
    if builder is None:
        if "ftype" in config and config["ftype"] is None:
            raise RuntimeError("Must specify either 'flow' or 'ftype'.")
        builder = get_flow_builder(config.get("ftype") or "realnvp")
    elif not callable(builder):
        raise TypeError(f"'flow' must be callable, got {type(builder)}")
    extra = dict(config.get("kwargs") or {})
    for k in _BUILDER_KEYS:
        if k in config:
            extra[k] = config[k]
    generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
    built = builder(
        dim,
        n_blocks=config.get("n_blocks", 4),
        n_neurons=get_n_neurons(config.get("n_neurons"), n_inputs=dim),
        n_layers=config.get("n_layers", 2),
        generator=generator,
        **extra,
    )
    if isinstance(built, Flow):
        return built.eval()
    base = _make_base_distribution(
        config.get("distribution"), dim, config.get("distribution_kwargs"), generator
    )
    return Flow(built, base, dim).eval()


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
