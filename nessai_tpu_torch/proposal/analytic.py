"""Analytic proposal: draw directly from the prior. Counterpart of
``nessai_tpu/proposal/analytic.py``."""

import datetime

from .base import Proposal

__all__ = ["AnalyticProposal"]


class AnalyticProposal(Proposal):
    """Pops samples from a pool of prior draws, repopulating when empty."""

    def __init__(self, *args, poolsize: int = 1000, **kwargs):
        super().__init__(*args, **kwargs)
        self.populated = False
        self._poolsize = int(poolsize)

    @property
    def poolsize(self) -> int:
        return self._poolsize

    def populate(self, N=None) -> None:
        """A pool of ``N`` (default ``poolsize``) exact prior draws."""
        N = self.poolsize if N is None else N
        st = datetime.datetime.now()
        self.samples = self.model.new_point(N=N)
        self.samples["logP"] = self.model.batch_evaluate_log_prior(self.samples)
        self.indices = self.rng.permutation(self.samples.size).tolist()
        self.samples["logL"] = self.model.batch_evaluate_log_likelihood(self.samples)
        self.population_time += datetime.datetime.now() - st
        self.populated = True

    def draw(self, old_sample):
        if not self.populated:
            self.populate()
        index = self.indices.pop()
        new_sample = self.samples[index]
        if not self.indices:
            self.populated = False
        return new_sample
