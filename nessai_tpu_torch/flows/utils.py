"""Flow construction. Counterpart of ``nessai_tpu/flows/utils.py``
(``get_n_neurons``, ``configure_model``) for the RealNVP family."""

import copy
import torch

from .base import Flow
from .distributions import StandardNormal
from .realnvp import build_realnvp_bijector

__all__ = ["get_n_neurons", "configure_model"]

_BUILDER_KEYS = ("mask", "net", "volume_preserving", "activation")


def get_n_neurons(n_neurons, n_inputs: int) -> int:
    """Resolve the conditioner width: ``None`` and ``"auto"`` are
    ``2 * n_inputs``."""
    if n_neurons is None or n_neurons == "auto":
        return 2 * n_inputs
    if isinstance(n_neurons, str):
        raise ValueError(f"Could not get number of neurons: unknown value {n_neurons!r}")
    return int(n_neurons)


def configure_model(config: dict) -> Flow:
    """Build a :class:`Flow` from a flow config dict (keys ``n_inputs,
    n_blocks, n_layers, n_neurons, ftype, distribution, kwargs, seed``).
    Weights and permutations are drawn from a ``torch.Generator`` seeded
    with ``config['seed']`` (default 0)."""
    config = copy.deepcopy(config)
    dim = config.get("n_inputs")
    if not isinstance(dim, int):
        raise TypeError(f"Number of inputs (n_inputs) must be an int, got: {dim}")
    ftype = (config.get("ftype") or "realnvp").lower()
    if ftype != "realnvp":
        raise ValueError(f"Flow {ftype!r} is not in the PyTorch port yet; known: realnvp")
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
    bijector = build_realnvp_bijector(
        dim,
        n_blocks=config.get("n_blocks", 4),
        n_neurons=get_n_neurons(config.get("n_neurons"), n_inputs=dim),
        n_layers=config.get("n_layers", 2),
        generator=generator,
        **extra,
    )
    return Flow(bijector, StandardNormal(dim), dim)
