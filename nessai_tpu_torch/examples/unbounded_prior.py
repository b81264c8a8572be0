#!/usr/bin/env python
"""An unbounded (Gaussian) prior on one parameter: x uniform on [-10, 10],
y normal with a scale of 5 (on a box of [-100, 100] that the prior never
reaches), a unit normal likelihood in both. The prior cannot be drawn by
rejection from the box, so the model draws its own new points, and y
takes the z-score reparameterisation.

Counterpart of ``examples/unbounded_prior.py``. Analytic log-evidence:
``-log 20 - log(2 pi 26) / 2``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.unbounded_prior``.
"""

import numpy as np
from scipy.stats import norm

from ..livepoint import numpy_array_to_live_points
from ..model import Model

OUTPUT = "./outdir/unbounded_prior/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, reparameterisations={"x": "default", "y": "zscore"})


class GaussianPriorModel(Model):
    """Uniform prior on x, Gaussian prior on y (unbounded)."""

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-100, 100]}

    def log_prior(self, x):
        log_p = -np.log(20) * np.ones(x.size)
        log_p += norm.logpdf(x["y"], scale=5)
        return log_p

    def new_point(self, N=1):
        rng = self._require_rng()
        arr = np.stack([rng.uniform(-10, 10, N), norm.rvs(scale=5, size=N, random_state=rng)], axis=1)
        return numpy_array_to_live_points(arr, self.names)

    def new_point_log_prob(self, x):
        return self.log_prior(x)

    def log_likelihood(self, x):
        return norm.logpdf(x["x"]) + norm.logpdf(x["y"])

    @property
    def analytic_log_evidence(self) -> float:
        # the x integral over the box is 1 / 20 (its tails outside are
        # 7.6e-24); the y integral is the N(0, 5) density's convolution
        # with N(0, 1) at 0
        return float(-np.log(20.0) - 0.5 * np.log(2 * np.pi * 26.0))


if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(GaussianPriorModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
