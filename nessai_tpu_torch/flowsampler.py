"""FlowSampler: the top-level user API. Counterpart of
``nessai_tpu/flowsampler.py`` for the standard and the importance nested
sampler, without checkpoint/resume, plots and result files."""

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
        """The log-evidence: the importance nested sampler's redrawn
        (final) estimate once a redraw has run, else the sampler's."""
        final = getattr(self.ns, "final_log_evidence", None)
        if final is not None:
            return final
        return self.ns.log_evidence

    log_evidence = logZ

    @property
    def logZ_error(self) -> float:
        if getattr(self.ns, "final_log_evidence", None) is not None:
            return self.ns.final_log_evidence_error
        return self.ns.log_evidence_error

    log_evidence_error = logZ_error

    @property
    def rng(self):
        return self.ns.rng

    def run(
        self,
        plot: bool = False,
        save: bool = False,
        posterior_sampling_method: Optional[str] = None,
        close_pool: Optional[bool] = None,
        **kwargs,
    ):
        """Run the sampler; returns ``(logZ, nested_samples)`` and sets
        ``posterior_samples`` (by ``posterior_sampling_method``; the
        default is rejection sampling for the standard sampler and
        importance sampling for the importance nested sampler).
        ``kwargs`` go to :meth:`run_importance_nested_sampler`."""
        plots = {k: kwargs.pop(k) for k in ("plot_indices", "plot_posterior", "plot_logXlogL") if k in kwargs}
        if plot or save or close_pool or any(plots.values()):
            raise NotImplementedError(
                "Plots, result files and the likelihood pool are not in the PyTorch port yet "
                "(ROADMAP §1 item 8); pass plot=False, save=False"
            )
        if self.importance_nested_sampler:
            if posterior_sampling_method is not None:
                kwargs["posterior_sampling_method"] = posterior_sampling_method
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
            nested_samples,
            nlive=nlive_schedule,
            method=posterior_sampling_method or "rejection_sampling",
            rng=self.ns.rng,
        )
        logger.info("Returned %s posterior samples", self.posterior_samples.size)
        self.nested_samples = nested_samples
        return self.logZ, nested_samples

    def run_importance_nested_sampler(
        self,
        posterior_sampling_method: str = "importance_sampling",
        redraw_samples: bool = False,
        n_posterior_samples: Optional[int] = None,
        compute_initial_posterior: bool = False,
        **kwargs,
    ):
        """Run the importance nested sampler; returns ``(logZ, samples)``
        with every sample in the model space and sets
        ``posterior_samples``. With ``redraw_samples`` the final redraw
        (:meth:`ImportanceNestedSampler.draw_final_samples`, which takes
        ``kwargs``) runs to a posterior ESS of ``n_posterior_samples``;
        the posterior samples and logZ then come from it, and the
        sampler's estimate stays in ``initial_logZ``."""
        self.ns.initialise()
        self.ns.nested_sampling_loop()
        logger.info("Total sampling time: %s", self.ns.sampling_time)
        if redraw_samples:
            logger.info("Redrawing %s samples", n_posterior_samples)
            self.initial_logZ = self.ns.log_evidence
            self.initial_logZ_error = self.ns.log_evidence_error
            if compute_initial_posterior:
                self.initial_posterior_samples = self.ns.draw_posterior_samples(
                    sampling_method=posterior_sampling_method, use_final_samples=False
                )
            self.ns.draw_final_samples(n_post=n_posterior_samples, **kwargs)
        self.posterior_samples = self.ns.draw_posterior_samples(
            sampling_method=posterior_sampling_method, use_final_samples=redraw_samples
        )
        if not redraw_samples:
            self.initial_posterior_samples = self.posterior_samples
        logger.info("Returned %s posterior samples", self.posterior_samples.size)
        self.nested_samples = np.asarray(self.ns.nested_samples)
        return self.logZ, self.nested_samples
