#!/usr/bin/env python
"""The 2-D Gaussian example: a unit normal likelihood in x and y on a
uniform prior on [-10, 10]^2, at the standard sampler's defaults (nlive
2000, a RealNVP of 4 couplings).

Counterpart of ``examples/2d_gaussian.py`` (a module name cannot start
with a digit). Analytic log-evidence: ``-log 400``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gaussian_2d``.
"""

import math

import numpy as np
import torch
from scipy.stats import norm

from ..model import Model

OUTPUT = "./outdir/2d_gaussian_example/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234)


class GaussianModel(Model):
    """A simple two-dimensional Gaussian likelihood."""

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p

    def log_likelihood(self, x):
        log_l = np.zeros(x.size)
        for n in self.names:
            log_l += norm.logpdf(x[n])
        return log_l

    def torch_log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(x**2, dim=-1) - x.shape[-1] * 0.5 * math.log(2 * math.pi)

    @property
    def analytic_log_evidence(self) -> float:
        return -np.log(400.0)


if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(GaussianModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
