"""Adapters for flows defined outside the package. Counterpart of
``nessai_tpu/experimental/flows/__init__.py``:

- :func:`~nessai_tpu_torch.flows.register_flow` registers a builder under
  an ``ftype`` name, and the ``flow`` config key takes a builder itself;
- :class:`ExternalBijector` wraps plain ``(init, forward, inverse)``
  functions as a bijector module for any chain;
- :func:`get_glasflow_class` resolves the ``glasflow-`` names to the
  port's builders.
"""

import torch
from torch import nn

from ...flows.utils import get_native_flow_class, register_flow

__all__ = [
    "ExternalBijector",
    "get_glasflow_class",
    "get_native_flow_class",
    "register_flow",
]


class ExternalBijector(nn.Module):
    """Externally defined functions as a bijector.

    Parameters
    ----------
    init_fn : callable
        ``init_fn(generator) -> dict`` of name -> tensor, the initial
        parameters (drawn from ``generator``, a ``torch.Generator``, or
        None); each becomes an ``nn.Parameter``, so training updates it
        and the state dict holds it.
    forward_fn : callable
        ``forward_fn(params, x, context) -> (z, log_det)``: data to
        latent with the per-row log-Jacobian determinant.
    inverse_fn : callable
        ``inverse_fn(params, z, context) -> (x, log_det)``.

    ``params`` is the dict of the parameters, on the module's device.
    """

    def __init__(self, init_fn, forward_fn, inverse_fn, generator=None):
        super().__init__()
        if not all(callable(f) for f in (init_fn, forward_fn, inverse_fn)):
            raise TypeError("init_fn, forward_fn and inverse_fn must be callable")
        self._forward_fn = forward_fn
        self._inverse_fn = inverse_fn
        self.params = nn.ParameterDict(
            {name: nn.Parameter(torch.as_tensor(value)) for name, value in dict(init_fn(generator)).items()}
        )

    def forward(self, x, context=None):
        z, log_det = self._forward_fn(dict(self.params), x, context)
        return z, torch.as_tensor(log_det, device=z.device)

    def inverse(self, z, context=None):
        x, log_det = self._inverse_fn(dict(self.params), z, context)
        return x, torch.as_tensor(log_det, device=x.device)


def get_glasflow_class(name: str):
    """The builder of a ``glasflow-`` flow name: the name must contain
    ``glasflow`` and be registered (the glasflow architectures are the
    port's own builders under the prefixed names)."""
    name = name.lower()
    if "glasflow" not in name:
        raise ValueError("'glasflow' missing from name")
    try:
        return get_native_flow_class(name)
    except ValueError:
        raise ValueError(f"{name} is not a known glasflow flow")
