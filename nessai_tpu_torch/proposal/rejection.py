"""Rejection proposal for the uninformed phase. Counterpart of
``nessai_tpu/proposal/rejection.py``: prior draws (``model.new_point``)
rejected against the prior; the pool's likelihoods are one batched
evaluation (on the device for models with a ``torch_log_likelihood``)."""

import datetime

import numpy as np

from .analytic import AnalyticProposal

__all__ = ["RejectionProposal"]


class RejectionProposal(AnalyticProposal):
    """Draw from ``model.new_point`` and reject against the prior so the
    pool is exactly prior-distributed."""

    #: cap on the adaptive pool growth
    max_poolsize_scale: float = 4.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.population_acceptance = None
        #: NS mean block acceptance, pushed by the sampler
        self.ns_acceptance = None
        self._pool_scale = 1.0

    def draw_proposal(self, N=None):
        return self.model.new_point(N=self.poolsize if N is None else N)

    def log_proposal(self, x):
        return self.model.new_point_log_prob(x)

    def compute_weights(self, x):
        """logW = logP - logQ, with logQ the density of ``new_point``."""
        x["logP"] = self.model.batch_evaluate_log_prior(x)
        return x["logP"] - self.log_proposal(x)

    def populate(self, N=None) -> None:
        if N is None:
            # the uninformed phase consumes ~1/X pool entries per
            # iteration: grow the pool geometrically (and at least with
            # the observed 1/acceptance), capped
            scale = self._pool_scale
            acc = self.ns_acceptance
            if acc is not None and np.isfinite(acc) and 0.0 < acc < 1.0:
                scale = max(scale, 1.0 / acc)
            scale = min(self.max_poolsize_scale, scale)
            N = int(self.poolsize * scale)
            self._pool_scale = min(self.max_poolsize_scale, self._pool_scale * 1.6)
        st = datetime.datetime.now()
        x = self.draw_proposal(N=N)
        log_w = self.compute_weights(x)
        log_w = log_w - np.nanmax(log_w)
        log_u = np.log(self.rng.random(N))
        self.samples = x[np.flatnonzero(log_w > log_u)]
        self.population_acceptance = self.samples.size / N
        self.indices = self.rng.permutation(self.samples.size).tolist()
        self.samples["logL"] = self.model.batch_evaluate_log_likelihood(self.samples)
        self.population_time += datetime.datetime.now() - st
        self.populated = True
