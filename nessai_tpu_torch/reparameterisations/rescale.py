"""Scale-and-shift (z-score) reparameterisation. Counterpart of
``ScaleAndShift`` in ``nessai_tpu/reparameterisations/rescale.py``
without the pre/post rescaling functions."""

import numpy as np
import torch

from .base import Reparameterisation

__all__ = ["ScaleAndShift"]


class ScaleAndShift(Reparameterisation):
    """x' = (x - shift) / scale; with ``estimate_scale``/``estimate_shift``
    the scale and shift are the standard deviation and mean of the
    training data at each :meth:`update` (z-score)."""

    def __init__(
        self,
        parameters=None,
        prior_bounds=None,
        scale=None,
        shift=None,
        estimate: bool = False,
        estimate_scale: bool = False,
        estimate_shift: bool = False,
        rng=None,
    ):
        super().__init__(parameters, prior_bounds, rng)
        self.estimate_scale = estimate_scale or estimate
        self.estimate_shift = estimate_shift or estimate
        if scale is None and not self.estimate_scale:
            raise RuntimeError("Must specify a scale or enable estimate_scale")
        self.scale = self._per_param(scale, 1.0)
        self.shift = self._per_param(shift, 0.0)

    def _per_param(self, value, default):
        if value is None:
            return {p: float(default) for p in self.parameters}
        if isinstance(value, dict):
            if set(value) != set(self.parameters):
                raise RuntimeError(
                    f"Mismatched parameters: {list(value)} vs {self.parameters}"
                )
            return {p: float(value[p]) for p in self.parameters}
        value = np.broadcast_to(np.asarray(value, dtype=float), (len(self.parameters),))
        return {p: float(v) for p, v in zip(self.parameters, value)}

    def update(self, x) -> None:
        for p in self.parameters:
            vals = np.asarray(x[p], dtype=float)
            if self.estimate_scale:
                self.scale[p] = float(np.std(vals)) or 1.0
            if self.estimate_shift:
                self.shift[p] = float(np.mean(vals))

    def reset(self) -> None:
        if self.estimate_scale:
            self.scale = {p: 1.0 for p in self.parameters}
        if self.estimate_shift:
            self.shift = {p: 0.0 for p in self.parameters}

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            x_prime[pp] = (np.asarray(x[p], dtype=float) - self.shift[p]) / self.scale[p]
            log_j = log_j - np.log(abs(self.scale[p]))
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            x[p] = np.asarray(x_prime[pp], dtype=float) * self.scale[p] + self.shift[p]
            log_j = log_j + np.log(abs(self.scale[p]))
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """``x = x' * scale + shift`` in float32 on the columns' device,
        with the current (per-training) scale and shift."""
        device = next(iter(cols.values())).device
        scale = torch.tensor(
            [self.scale[p] for p in self.parameters], dtype=torch.float32, device=device
        )
        shift = torch.tensor(
            [self.shift[p] for p in self.parameters], dtype=torch.float32, device=device
        )
        log_j = 0.0
        updates = {}
        for i, (p, pp) in enumerate(zip(self.parameters, self.prime_parameters)):
            updates[p] = cols[pp] * scale[i] + shift[i]
            log_j = log_j + torch.log(torch.abs(scale[i]))
        return updates, log_j
