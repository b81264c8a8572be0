#!/usr/bin/env python
"""A discrete parameter through dequantisation: model selection between a
sine and a cosine by a weight w in {0, 1}, with an amplitude on [0.1, 2],
fitted to 50 noisy points of a sine. The model draws w from {0, 1}, its
prior is zero off the integers, and ``dequantise`` adds U[0, 1) noise to
w for the flow and floors it on the way back. Its likelihood is a host
loop over the points.

Counterpart of ``examples/discrete_parameter.py`` (the same data, from
the same seed). Log-evidence: :func:`discrete_log_evidence`.

Run on the GPU with ``python -m nessai_tpu_torch.examples.discrete_parameter``.
"""

import numpy as np
from scipy.special import logsumexp
from scipy.stats import norm

from ..livepoint import empty_structured_array
from ..model import Model

OUTPUT = "./outdir/discrete_parameter/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, reparameterisations={"w": "dequantise", "amp": "default"})

rng_data = np.random.default_rng(42)
x_data = np.linspace(0, 2 * np.pi, 50)
y_data = np.sin(x_data) + rng_data.normal(scale=0.2, size=50)


class DiscreteModel(Model):
    """Signal = w * sin(x) + (1 - w) * cos(x) with discrete w in {0, 1}."""

    def __init__(self):
        self.names = ["amp", "w"]
        self.bounds = {"amp": [0.1, 2.0], "w": [0, 1]}
        self.discrete_parameters = ["w"]

    def new_point(self, N=1):
        rng = self._require_rng()
        x = empty_structured_array(N, self.names)
        x["amp"] = rng.uniform(*self.bounds["amp"], size=N)
        x["w"] = rng.choice([0, 1], size=N)
        return x

    def new_point_log_prob(self, x):
        return -np.log(np.ptp(self.bounds["amp"]) * 2.0) * np.ones(len(x))

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        log_p -= np.log(np.ptp(self.bounds["amp"]))
        with np.errstate(divide="ignore"):
            log_p += np.log(~(x["w"] % 1).astype(bool))
        log_p -= np.log(2)
        return log_p

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        out = np.zeros(len(x))
        for i, point in enumerate(x):
            w = np.round(point["w"])
            signal = point["amp"] * (w * np.sin(x_data) + (1 - w) * np.cos(x_data))
            out[i] = norm.logpdf(y_data - signal, scale=0.2).sum()
        return out

    @property
    def analytic_log_evidence(self) -> float:
        return discrete_log_evidence()


def discrete_log_evidence(n: int = 20001) -> float:
    """log Z of :class:`DiscreteModel`: for each w the trapezoid rule over
    the amplitude's prior [0.1, 2] on ``n`` points (the likelihood is a
    Gaussian in the amplitude, 0.014 wide under w = 1: 10001 and 20001
    points agree to 1e-10), each w with prior mass 1/2."""
    amp = np.linspace(0.1, 2.0, n)
    w_trap = np.full(n, amp[1] - amp[0])
    w_trap[0] = w_trap[-1] = 0.5 * (amp[1] - amp[0])
    terms = []
    for signal in (np.cos(x_data), np.sin(x_data)):
        log_l = norm.logpdf(y_data[None, :] - amp[:, None] * signal[None, :], scale=0.2).sum(axis=1)
        terms.append(logsumexp(log_l, b=w_trap) - np.log(1.9))
    return float(logsumexp(terms) - np.log(2.0))


if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(DiscreteModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
