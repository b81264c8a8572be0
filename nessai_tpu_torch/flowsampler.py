"""FlowSampler: the top-level user API. Counterpart of
``nessai_tpu/flowsampler.py`` for the standard sampler, without
checkpoint/resume, plots and result files."""

import logging
import os
from typing import Optional

import numpy as np

from .posterior import draw_posterior_samples
from .samplers.nestedsampler import NestedSampler

logger = logging.getLogger(__name__)

__all__ = ["FlowSampler"]


class FlowSampler:
    """Set up and run the standard nested sampler.

    ``device`` (default ``None``, meaning CUDA) is where the flow trains
    and the pool is populated. Without a GPU, construction raises
    unless ``device="cpu"`` is passed.
    """

    def __init__(
        self,
        model,
        output: Optional[str] = None,
        resume: bool = False,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        device=None,
        **kwargs,
    ):
        if resume:
            raise NotImplementedError("Resuming is not in the PyTorch port yet; pass resume=False")
        if output is None:
            output = os.getcwd()
        self.output = os.path.join(output, "")
        os.makedirs(self.output, exist_ok=True)
        self.ns = NestedSampler(
            model, output=self.output, seed=seed, rng=rng, device=device, **kwargs
        )

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

    def run(self, plot: bool = False, save: bool = False):
        """Run the sampler; returns ``(logZ, nested_samples)`` and sets
        ``posterior_samples``."""
        if plot or save:
            raise NotImplementedError(
                "Plots and result files are not in the PyTorch port yet; "
                "pass plot=False, save=False"
            )
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
