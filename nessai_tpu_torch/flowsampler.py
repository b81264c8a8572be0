"""FlowSampler: the top-level user API. Counterpart of
``nessai_tpu/flowsampler.py`` for the standard and the importance nested
sampler, without checkpoint/resume, plots, result files and the final
redraw of the importance nested sampler."""

import logging
import os
from typing import Optional

import numpy as np

from .posterior import draw_posterior_samples
from .samplers.importancesampler import ImportanceNestedSampler
from .samplers.nestedsampler import NestedSampler

logger = logging.getLogger(__name__)

__all__ = ["FlowSampler"]


class FlowSampler:
    """Set up and run the standard nested sampler, or with
    ``importance_nested_sampler=True`` the importance nested sampler.

    ``device`` (default ``None``, meaning CUDA) is where the flows train
    and run. Without a GPU, construction raises unless ``device="cpu"``
    is passed.
    """

    def __init__(
        self,
        model,
        output: Optional[str] = None,
        importance_nested_sampler: bool = False,
        resume: bool = False,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        device=None,
        **kwargs,
    ):
        if resume:
            raise NotImplementedError(
                "Resuming is not in the PyTorch port yet (ROADMAP §1 item 8); pass resume=False"
            )
        if output is None:
            output = os.getcwd()
        self.output = os.path.join(output, "")
        os.makedirs(self.output, exist_ok=True)
        self.importance_nested_sampler = importance_nested_sampler
        sampler = ImportanceNestedSampler if importance_nested_sampler else NestedSampler
        self.ns = sampler(model, output=self.output, seed=seed, rng=rng, device=device, **kwargs)

    @property
    def logZ(self) -> float:
        return self.ns.log_evidence

    log_evidence = logZ

    @property
    def logZ_error(self) -> float:
        return self.ns.log_evidence_error

    log_evidence_error = logZ_error

    @property
    def rng(self):
        return self.ns.rng

    def run(self, plot: bool = False, save: bool = False, **kwargs):
        """Run the sampler; returns ``(logZ, nested_samples)`` and sets
        ``posterior_samples``. ``kwargs`` go to
        :meth:`run_importance_nested_sampler`."""
        if plot or save:
            raise NotImplementedError(
                "Plots and result files are not in the PyTorch port yet "
                "(ROADMAP §1 item 8); pass plot=False, save=False"
            )
        if self.importance_nested_sampler:
            return self.run_importance_nested_sampler(**kwargs)
        if kwargs:
            raise TypeError(f"Unexpected arguments for the standard sampler: {sorted(kwargs)}")
        self.ns.initialise()
        _, nested_samples = self.ns.nested_sampling_loop()
        n_ns = len(nested_samples)
        nlive_schedule = np.concatenate(
            [np.full(n_ns - self.ns.nlive, self.ns.nlive), np.arange(self.ns.nlive, 0, -1)]
        )
        self.posterior_samples = draw_posterior_samples(
            nested_samples, nlive=nlive_schedule, rng=self.ns.rng
        )
        logger.info("Returned %s posterior samples", self.posterior_samples.size)
        self.nested_samples = nested_samples
        return self.logZ, nested_samples

    def run_importance_nested_sampler(self, redraw_samples: bool = False):
        """Run the importance nested sampler; returns ``(logZ, samples)``
        (every sample, in the unit hypercube) and sets
        ``posterior_samples`` (importance-resampled, as many as the
        effective sample size)."""
        if redraw_samples:
            raise NotImplementedError(
                "The final redraw of the importance nested sampler is not in the "
                "PyTorch port yet (ROADMAP §1 item 3b); pass redraw_samples=False"
            )
        self.ns.initialise()
        _, samples = self.ns.nested_sampling_loop()
        logger.info("Total sampling time: %s", self.ns.sampling_time)
        self.posterior_samples = self.ns.draw_posterior_samples()
        logger.info("Returned %s posterior samples", self.posterior_samples.size)
        self.nested_samples = samples
        return self.logZ, samples
