"""Flow construction. Counterpart of ``nessai_tpu/flows/utils.py``
(``get_n_neurons``, the builder registry, ``configure_model``,
``reset_weights``) for the RealNVP and neural-spline families."""

import copy

import torch

from .base import Flow
from .bijectors import Permutation
from .distributions import StandardNormal
from .nsf import build_nsf_bijector
from .realnvp import build_realnvp_bijector

__all__ = ["get_n_neurons", "get_flow_builder", "configure_model", "reset_weights"]

#: ``ftype`` names and their builders (``nessai_tpu/flows/utils.py:42-52``);
#: the glasflow-prefixed names map to the same builders.
_BUILDERS = {
    "realnvp": build_realnvp_bijector,
    "frealnvp": build_realnvp_bijector,
    "spline": build_nsf_bijector,
    "nsf": build_nsf_bijector,
    "rq-nsf": build_nsf_bijector,
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
)


def get_n_neurons(n_neurons, n_inputs: int) -> int:
    """Resolve the conditioner width: ``None`` and ``"auto"`` are
    ``2 * n_inputs``."""
    if n_neurons is None or n_neurons == "auto":
        return 2 * n_inputs
    if isinstance(n_neurons, str):
        raise ValueError(f"Could not get number of neurons: unknown value {n_neurons!r}")
    return int(n_neurons)


def get_flow_builder(ftype: str):
    """The bijector builder registered under ``ftype``."""
    name = ftype.lower()
    if name == "maf":
        raise NotImplementedError(
            "Flow 'maf' is not in the PyTorch port yet (ROADMAP §1 item 2)"
        )
    if name not in _BUILDERS:
        raise ValueError(f"Unknown flow: {name}. Known flows are: {sorted(_BUILDERS)}")
    return _BUILDERS[name]


def configure_model(config: dict) -> Flow:
    """Build a :class:`Flow` from a flow config dict (keys ``n_inputs,
    n_blocks, n_layers, n_neurons, ftype, distribution, kwargs, seed``
    and the builder keys). Weights and permutations are drawn from a
    ``torch.Generator`` seeded with ``config['seed']`` (default 0)."""
    config = copy.deepcopy(config)
    dim = config.get("n_inputs")
    if not isinstance(dim, int):
        raise TypeError(f"Number of inputs (n_inputs) must be an int, got: {dim}")
    builder = get_flow_builder(config.get("ftype") or "realnvp")
    if config.get("distribution") not in (None, "normal", "mvn"):
        raise ValueError(
            f"Base distribution {config['distribution']!r} is not in the "
            "PyTorch port yet"
        )
    extra = dict(config.get("kwargs") or {})
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
    return Flow(bijector, StandardNormal(dim), dim)


@torch.no_grad()
def reset_weights(flow: Flow, config: dict, generator: torch.Generator) -> None:
    """Give ``flow`` (built from ``config``) fresh weights in place, as a
    new flow from ``config`` starts, with its seed drawn from
    ``generator``; the permutations keep their order
    (``nessai_tpu/flows/utils.py:reset_weights``)."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    fresh = configure_model(dict(config, seed=seed))
    for b, new in zip(flow.bijector.bijectors, fresh.bijector.bijectors, strict=True):
        if not isinstance(b, Permutation):
            b.load_state_dict(new.state_dict())
