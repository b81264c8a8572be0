#!/usr/bin/env python
"""A prior that is not uniform in the unit hypercube: a truncated normal
of scale 0.5 on [-10, 10] in each of two dimensions, a normal likelihood
N(1, 0.5) in each. ``from_unit_hypercube`` is an affine map (it does not
make the prior uniform), so the model supplies the prior's density in the
hypercube (``log_prior_unit_hypercube``). Both samplers run at nlive 1000,
their evidences are compared, and their posteriors drawn in one figure.

Counterpart of ``examples/importance_nested_sampler/hypercube_prior.py``.
Analytic log-evidence: ``2 (-log(pi) / 2 - 1)``, each dimension's
N(0, 0.5) prior against the N(1, 0.5) likelihood.

Run on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.hypercube_prior``.
"""

import os

import numpy as np
from scipy.stats import norm, truncnorm

from ...model import Model

OUTPUT = os.path.join("outdir", "ins_non_uniform_prior")

#: the dimensions of the script's model
DIMS = 2

#: the script's arguments of its two samplers (their outputs and
#: ``resume=False`` apart): the standard one, then the importance one
STANDARD_KWARGS = dict(nlive=1000, seed=1234, importance_nested_sampler=False)
SAMPLER_KWARGS = dict(nlive=1000, seed=1234, importance_nested_sampler=True)


class ModelWithNonUniformPrior(Model):
    """A likelihood with a non-uniform prior in the unit hypercube."""

    def __init__(self, dims):
        self.names = [f"x_{d}" for d in range(dims)]
        self.bounds = {n: [-10.0, 10.0] for n in self.names}
        scale = 0.5
        self.prior_dist = truncnorm(-10 / scale, 10 / scale, scale=scale)
        loc = 0.5
        h_scale = scale / 20
        self.hypercube_prior_dist = truncnorm((0 - loc) / h_scale, (1 - loc) / h_scale, loc=loc, scale=h_scale)
        self.likelihood_dist = norm(loc=1.0, scale=0.5)

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype=float)
        log_p += self.prior_dist.logpdf(self.unstructured_view(x)).sum(axis=-1)
        return log_p

    def log_likelihood(self, x):
        return self.likelihood_dist.logpdf(self.unstructured_view(x)).sum(axis=-1)

    def from_unit_hypercube(self, x):
        """An affine map from the hypercube: it does not make the prior
        uniform, hence :meth:`log_prior_unit_hypercube`."""
        x_out = x.copy()
        for n in self.names:
            x_out[n] = (self.bounds[n][1] - self.bounds[n][0]) * x[n] + self.bounds[n][0]
        return x_out

    def to_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            x_out[n] = (x[n] - self.bounds[n][0]) / (self.bounds[n][1] - self.bounds[n][0])
        return x_out

    def log_prior_unit_hypercube(self, x) -> np.ndarray:
        """The prior's density in the hypercube, matching
        :meth:`from_unit_hypercube`."""
        return np.log(self.in_unit_hypercube(x), dtype=float) + self.hypercube_prior_dist.logpdf(
            self.unstructured_view(x)
        ).sum(axis=-1)

    @property
    def analytic_log_evidence(self) -> float:
        return float(len(self.names) * (-0.5 * np.log(np.pi) - 1.0))


def plot_comparison(fs, fs_ins, output: str = OUTPUT) -> str:
    """Both samplers' posteriors in one corner plot, written to
    ``output/posterior_comparison.png``; returns the file's path."""
    from ...plot import corner_plot

    names = fs.ns.model.names
    filename = os.path.join(output, "posterior_comparison.png")
    fig = corner_plot(fs.posterior_samples, include=names)
    corner_plot(fs_ins.posterior_samples, fig=fig, include=names, filename=filename)
    return filename


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    fs = FlowSampler(
        ModelWithNonUniformPrior(DIMS), output=os.path.join(OUTPUT, "standard"), resume=False, **STANDARD_KWARGS
    )
    fs.run()
    fs_ins = FlowSampler(
        ModelWithNonUniformPrior(DIMS), output=os.path.join(OUTPUT, "ins"), resume=False, **SAMPLER_KWARGS
    )
    fs_ins.run()
    print(f"Log-evidences: {fs.log_evidence:.3f} vs {fs_ins.log_evidence:.3f}")
    plot_comparison(fs, fs_ins)
