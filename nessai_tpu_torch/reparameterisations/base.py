"""Reparameterisation base class. Counterpart of
``nessai_tpu/reparameterisations/base.py``.

A reparameterisation is a host-side bijection x <-> x' on structured
live points, ``reparameterise(x, x_prime, log_j) -> (x, x_prime,
log_j)``, plus an optional device inverse :meth:`torch_inverse` used by
the flow proposal's populate.
"""

import numpy as np

__all__ = ["Reparameterisation"]


def _as_list(parameters):
    if parameters is None:
        return []
    if isinstance(parameters, str):
        return [parameters]
    if isinstance(parameters, list):
        return list(parameters)
    raise TypeError("Parameters must be a string or a list of strings.")


class Reparameterisation:
    """Base reparameterisation over ``parameters`` with outputs
    ``prime_parameters`` (``<name>_prime`` unless given)."""

    #: Set if the reparameterisation contributes a log-prior term
    has_prior = False
    #: Set if the reparameterisation defines a prior on x' space
    has_prime_prior = False
    one_to_one = True

    def __init__(self, parameters=None, prior_bounds=None, rng=None, prime_parameters=None):
        self.parameters = _as_list(parameters)
        if not self.parameters:
            raise RuntimeError("Must specify parameters")
        self.prime_parameters = _as_list(prime_parameters) or [
            f"{p}_prime" for p in self.parameters
        ]
        self.rng = rng if rng is not None else np.random.default_rng()
        if isinstance(prior_bounds, (list, tuple, np.ndarray)):
            prior_bounds = {self.parameters[0]: prior_bounds}
        self.prior_bounds = (
            None
            if prior_bounds is None
            else {p: np.asarray(b, dtype=float) for p, b in prior_bounds.items()}
        )

    @property
    def name(self) -> str:
        return type(self).__name__.lower() + "_" + "_".join(self.parameters)

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        raise NotImplementedError

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        raise NotImplementedError

    def update(self, x) -> None:
        """Update data-driven state from training data."""

    def reset(self) -> None:
        """Reset data-driven state."""

    def torch_inverse(self, cols: dict):
        """Device inverse x' -> x: ``cols`` maps names to ``[n]`` float32
        tensors; returns ``(updates, log_j)`` with the x-space columns
        this reparameterisation produces and its ``log|dx/dx'|``."""
        raise NotImplementedError

    def log_prior(self, x):
        return 0.0

    def __str__(self):
        return f"{type(self).__name__}({self.parameters})"
