"""Testing utilities. Counterpart of ``nessai_tpu/utils/testing.py``."""

import math

import numpy as np
import torch

from ..model import Model

__all__ = ["IntegrationTestModel", "GaussianMixture", "assert_structured_arrays_equal"]


class IntegrationTestModel(Model):
    """n-dim unit Gaussian with a uniform prior on [-10, 10]^n and
    analytic unit-hypercube maps.

    Analytic log-evidence: ``-n * log(20)``.
    """

    def __init__(self, dims: int = 2):
        self.names = [f"x_{i}" for i in range(dims)]
        self.bounds = {n: [-10.0, 10.0] for n in self.names}

    def log_prior(self, x):
        with np.errstate(divide="ignore"):
            log_p = np.log(self.in_bounds(x), dtype="float64")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        return -0.5 * np.sum(x**2, axis=-1) - 0.5 * x.shape[-1] * np.log(
            2 * np.pi
        )

    def to_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = (x[n] - lo) / (hi - lo)
        return x_out

    def from_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = x[n] * (hi - lo) + lo
        return x_out

    def torch_log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(x**2, dim=-1) - 0.5 * x.shape[-1] * math.log(
            2 * math.pi
        )

    @property
    def analytic_log_evidence(self) -> float:
        return -len(self.names) * np.log(20.0)


class GaussianMixture(IntegrationTestModel):
    """The model of ``examples/importance_nested_sampler/
    ins_gaussian_mixture.py``: an equal mixture of two unit Gaussians at
    (4, ..., 4) and (-4, ..., -4), a uniform prior on [-10, 10]^n and
    the analytic unit-hypercube maps, with a host (numpy) likelihood.

    Analytic log-evidence: ``-n * log(20)`` (the mass outside the box, 6σ
    from either mean, is negligible).
    """

    torch_log_likelihood = None

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        a = -0.5 * np.sum((x - 4) ** 2, axis=-1)
        b = -0.5 * np.sum((x + 4) ** 2, axis=-1)
        norm_const = x.shape[-1] * 0.5 * np.log(2 * np.pi)
        return np.logaddexp(a, b) - np.log(2) - norm_const


def assert_structured_arrays_equal(x, y, atol=0.0, rtol=0.0) -> None:
    """Assert two structured arrays are (approximately) equal field-wise."""
    if x.dtype != y.dtype:
        raise AssertionError(f"dtypes differ: {x.dtype} vs {y.dtype}")
    if x.shape != y.shape:
        raise AssertionError(f"shapes differ: {x.shape} vs {y.shape}")
    for n in x.dtype.names:
        xf, yf = x[n], y[n]
        if atol == 0.0 and rtol == 0.0:
            equal = (xf == yf) | (
                np.isnan(xf.astype(float)) & np.isnan(yf.astype(float))
                if np.issubdtype(xf.dtype, np.floating)
                else np.zeros(xf.shape, dtype=bool)
            )
            if not np.all(equal):
                raise AssertionError(f"field {n} differs: {xf} vs {yf}")
        else:
            np.testing.assert_allclose(
                xf, yf, atol=atol, rtol=rtol, err_msg=f"field {n}"
            )
