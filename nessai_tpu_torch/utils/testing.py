"""Testing utilities. Counterpart of ``nessai_tpu/utils/testing.py``."""

import math

import numpy as np
import torch

from ..model import Model

__all__ = ["IntegrationTestModel"]


class IntegrationTestModel(Model):
    """n-dim unit Gaussian with a uniform prior on [-10, 10]^n.

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

    def torch_log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(x**2, dim=-1) - 0.5 * x.shape[-1] * math.log(
            2 * math.pi
        )

    @property
    def analytic_log_evidence(self) -> float:
        return -len(self.names) * np.log(20.0)
