#!/usr/bin/env python
"""A likelihood on a pool of worker processes: a deliberately scalar (not
vectorised) unit normal likelihood in x and y on a uniform prior on
[-10, 10]^2, evaluated by two worker processes (``n_pool=2``).

Counterpart of ``examples/parallelisation_example.py``. The other two
options the script describes need no pool: a device likelihood
(``torch_log_likelihood``, batched on the GPU) and a vectorised numpy
likelihood. Analytic log-evidence: ``-log 400``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.parallelisation_example``.
"""

import numpy as np
from scipy.stats import norm

from ..model import Model

OUTPUT = "./outdir/parallelisation/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, n_pool=2)


class ScalarGaussian(Model):
    """Deliberately scalar likelihood to demonstrate the pool."""

    allow_vectorised = False

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        return norm.logpdf(x["x"]) + norm.logpdf(x["y"])

    @property
    def analytic_log_evidence(self) -> float:
        return -np.log(400.0)


if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(ScalarGaussian(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
