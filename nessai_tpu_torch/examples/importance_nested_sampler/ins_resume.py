#!/usr/bin/env python
"""Checkpoint and resume of the importance nested sampler: the 2-D unit
normal on [-10, 10]^2 at nlive 1000, checkpointed every two levels
(``checkpoint_on_iteration=True, checkpoint_interval=2``). Interrupt a run
and start it again with the same output: it resumes from the checkpoint.

Counterpart of ``examples/importance_nested_sampler/ins_resume.py``.
Analytic log-evidence: ``-log 400``.

Run on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.ins_resume``.
"""

import numpy as np
from scipy.stats import norm

from ...model import Model

OUTPUT = "./outdir/ins_resume/"

#: the script's sampler arguments (its output apart); it resumes by
#: default
SAMPLER_KWARGS = dict(
    importance_nested_sampler=True, seed=1234, nlive=1000, checkpoint_on_iteration=True, checkpoint_interval=2
)


class GaussianModel(Model):
    """The 2-D unit normal in x and y with the unit-hypercube maps."""

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {n: [-10.0, 10.0] for n in self.names}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        return norm.logpdf(x["x"]) + norm.logpdf(x["y"])

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

    @property
    def analytic_log_evidence(self) -> float:
        return -np.log(400.0)


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(GaussianModel(), output=OUTPUT, **SAMPLER_KWARGS).run()
