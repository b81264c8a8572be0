"""Dequantisation for discrete parameters. Counterpart of
``nessai_tpu/reparameterisations/discrete.py``: add U[0, 1) noise to
integer-valued parameters, then rescale to bounds; the inverse floors.
"""

import numpy as np
import torch

from .rescale import RescaleToBounds

__all__ = ["Dequantise"]


class Dequantise(RescaleToBounds):
    requires_bounded_prior = True

    def __init__(self, parameters=None, prior_bounds=None, rng=None, **kwargs):
        # widen the upper bound by 1 for the added uniform noise
        if prior_bounds is not None:
            if not isinstance(prior_bounds, dict):
                prior_bounds = {parameters if isinstance(parameters, str) else parameters[0]: prior_bounds}
            prior_bounds = {k: [np.asarray(v)[0], np.asarray(v)[1] + 1] for k, v in prior_bounds.items()}
        # live bound updates are off by default: with few discrete values
        # the live points can collapse onto one value and the estimated
        # range would shrink to zero
        kwargs.setdefault("update_bounds", False)
        super().__init__(parameters=parameters, prior_bounds=prior_bounds, rng=rng, **kwargs)

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        x = x.copy()
        for p in self.parameters:
            x[p] = np.floor(x[p]) + self.rng.random(len(np.atleast_1d(x[p])))
        return super().reparameterise(x, x_prime, log_j, **kwargs)

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        x, x_prime, log_j = super().inverse_reparameterise(x, x_prime, log_j, **kwargs)
        for p in self.parameters:
            x[p] = np.floor(x[p])
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """The inverse of :class:`RescaleToBounds`, floored."""
        out = super().torch_inverse(cols)
        if out is None:
            return None
        updates, log_j = out
        for p in self.parameters:
            updates[p] = torch.floor(updates[p])
        return updates, log_j
