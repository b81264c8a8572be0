"""FlowSampler: the top-level user API. Counterpart of
``nessai_tpu/flowsampler.py`` for the standard and the importance nested
sampler: resume-or-create, signal handling (a checkpoint, then exit),
the run, its plots and its result file."""

import logging
import os
import signal
import sys
from typing import Optional

import numpy as np

from . import config
from .livepoint import live_points_to_dict
from .posterior import draw_posterior_samples
from .samplers.importancesampler import ImportanceNestedSampler
from .samplers.nestedsampler import NestedSampler
from .utils.io import save_dict_to_hdf5, save_to_json
from .utils.profiling import annotate
from .utils.threading import configure_threads

logger = logging.getLogger(__name__)

__all__ = ["FlowSampler"]


class FlowSampler:
    """Set up and run the standard nested sampler, or with
    ``importance_nested_sampler=True`` the importance nested sampler.

    With ``resume`` (the default) the sampler is loaded from
    ``output/resume_file``, else from its ``.old`` copy, else (neither
    loads) created afresh; ``resume_data`` is an unpickled sampler to
    resume instead. SIGTERM, SIGINT and SIGALRM checkpoint the run and
    exit with ``exit_code`` (``signal_handling``). With ``n_pool`` (or a
    ``pool``) host likelihoods are evaluated by a pool of worker
    processes, created here before the sampler.

    ``device`` (default ``None``, meaning CUDA) is where the flows train
    and run, and where a resumed run rebuilds them. Without a GPU,
    construction raises unless ``device="cpu"`` is passed.

    Construction is traced as the span ``setup``, whose id is the run's
    (:attr:`run_id`); :meth:`run` as the span ``run``, with
    ``initialise``, ``finalise`` (in the sampler), ``posterior`` and
    ``result_write`` among its children.
    """

    #: the id of the run in a trace (None where construction was untraced)
    run_id = None

    def __init__(
        self,
        model,
        output: Optional[str] = None,
        importance_nested_sampler: bool = False,
        resume: bool = True,
        resume_file: str = "nested_sampler_resume.pkl",
        resume_data=None,
        weights_file: Optional[str] = None,
        weights_path: Optional[str] = None,
        eps: Optional[float] = None,
        exit_code: int = 130,
        pytorch_threads=None,
        max_threads=None,
        torch_dtype=None,
        signal_handling: bool = True,
        close_pool: bool = True,
        result_extension: str = "hdf5",
        disable_vectorisation: bool = False,
        likelihood_chunksize: Optional[int] = None,
        allow_multi_valued_likelihood: Optional[bool] = None,
        parallelise_prior: Optional[bool] = None,
        n_pool: Optional[int] = None,
        pool=None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        device=None,
        **kwargs,
    ):
        with annotate("setup") as span:
            span.set(run=span.id)
            self.run_id = span.id
            configure_threads(max_threads or pytorch_threads)
            self.exit_code = exit_code
            self.eps = eps
            if self.eps is not None:
                logger.info("Setting eps to %s", self.eps)
                config.general.eps = self.eps
            # the JAX package keeps the name (nessai_tpu/flowsampler.py:76-81)
            # and reads it nowhere: both packages compute in float32
            name = "float32"
            if torch_dtype is not None:
                name = str(torch_dtype).replace("torch.", "")
                if name not in ("float32", "float64"):
                    raise ValueError(f"Unknown torch_dtype: {torch_dtype}")
            self.torch_dtype = name
            self.close_pool = close_pool
            self.result_extension = result_extension
            self._result = None
            self.importance_nested_sampler = importance_nested_sampler

            if output is None:
                output = os.getcwd()
            self.output = os.path.join(output, "")
            os.makedirs(self.output, exist_ok=True)

            if disable_vectorisation:
                model.allow_vectorised = False
            if likelihood_chunksize:
                model.likelihood_chunksize = likelihood_chunksize
            if allow_multi_valued_likelihood is not None:
                model.allow_multi_valued_likelihood = allow_multi_valued_likelihood
            if parallelise_prior is not None:
                model.parallelise_prior = parallelise_prior
            model.configure_pool(pool=pool, n_pool=n_pool)

            SamplerClass = ImportanceNestedSampler if importance_nested_sampler else NestedSampler
            self.save_kwargs(kwargs)

            resumed = False
            weights_path = weights_path or weights_file
            resume_kwargs = dict(
                flow_config=kwargs.get("flow_config"),
                training_config=kwargs.get("training_config"),
                weights_path=weights_path,
                rng=rng,
                device=device,
            )
            if resume and not self.check_resume(resume_file, resume_data):
                logger.debug("Nothing to resume from")
            if resume_data is not None:
                self.ns = SamplerClass.resume_from_pickled_sampler(resume_data, model, **resume_kwargs)
                resumed = True
            elif resume:
                for rf in (
                    os.path.join(self.output, resume_file),
                    os.path.join(self.output, resume_file + ".old"),
                ):
                    if os.path.exists(rf):
                        try:
                            self.ns = SamplerClass.resume(rf, model, **resume_kwargs)
                            resumed = True
                            break
                        except Exception as e:
                            logger.error("Could not resume from %s: %s", rf, e)
            if not resumed:
                self.ns = SamplerClass(
                    model,
                    output=self.output,
                    resume_file=resume_file,
                    seed=seed,
                    rng=rng,
                    device=device,
                    **kwargs,
                )

            if signal_handling:
                try:
                    signal.signal(signal.SIGTERM, self.safe_exit)
                    signal.signal(signal.SIGINT, self.safe_exit)
                    signal.signal(signal.SIGALRM, self.safe_exit)
                except ValueError:
                    logger.error("Cannot set signal handlers outside main thread")

    def check_resume(self, resume_file, resume_data) -> bool:
        """Whether there is a resume file (or its ``.old`` copy), or
        ``resume_data``, to resume from."""
        return bool(
            resume_file
            and any(
                os.path.exists(os.path.join(self.output, f))
                for f in (resume_file, resume_file + ".old")
            )
        ) or resume_data is not None

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

    # ------------------------------------------------------------------
    def run(
        self,
        plot: bool = True,
        save: bool = True,
        posterior_sampling_method: Optional[str] = None,
        close_pool: Optional[bool] = None,
        **kwargs,
    ):
        """Run the sampler (:meth:`run_standard_sampler` or
        :meth:`run_importance_nested_sampler`, which take ``kwargs``);
        returns ``(logZ, nested_samples)`` and sets
        ``posterior_samples``."""
        common = dict(plot=plot, save=save, close_pool=close_pool)
        if posterior_sampling_method is not None:
            common["posterior_sampling_method"] = posterior_sampling_method
        with annotate("run", run=self.run_id):
            if self.importance_nested_sampler:
                return self.run_importance_nested_sampler(**common, **kwargs)
            return self.run_standard_sampler(**common, **kwargs)

    def run_standard_sampler(
        self,
        plot: bool = True,
        plot_indices: bool = True,
        plot_posterior: bool = True,
        plot_logXlogL: bool = True,
        save: bool = True,
        posterior_sampling_method: str = "rejection_sampling",
        close_pool: Optional[bool] = None,
    ):
        """Run the standard sampler, draw the posterior samples (by
        rejection sampling by default), then save the result file
        (``save``), the plots (``plot``, which needs matplotlib) and
        close the pool (``close_pool``, by default the constructor's)."""
        if close_pool is None:
            close_pool = self.close_pool
        with annotate("initialise"):
            self.ns.initialise()
        _, nested_samples = self.ns.nested_sampling_loop()
        logger.info("Total sampling time: %s", self.ns.sampling_time)
        with annotate("posterior"):
            n_ns = len(nested_samples)
            nlive_schedule = np.concatenate(
                [np.full(n_ns - self.ns.nlive, self.ns.nlive), np.arange(self.ns.nlive, 0, -1)]
            )
            self.posterior_samples = draw_posterior_samples(
                nested_samples,
                nlive=nlive_schedule,
                method=posterior_sampling_method,
                rng=self.ns.rng,
            )
        logger.info("Returned %s posterior samples", self.posterior_samples.size)
        self.nested_samples = nested_samples
        if save:
            with annotate("result_write"):
                self.save_results(os.path.join(self.output, "result"), extension=self.result_extension)
        if plot:
            from . import plot as _plot

            if plot_posterior:
                _plot.plot_live_points(
                    self.posterior_samples,
                    filename=os.path.join(self.output, "posterior_distribution.png"),
                )
            if plot_indices:
                _plot.plot_indices(
                    self.ns.insertion_indices,
                    self.ns.nlive,
                    filename=os.path.join(self.output, "insertion_indices.png"),
                )
            if plot_logXlogL:
                self.ns.state.plot(filename=os.path.join(self.output, "logXlogL.png"))
            self.ns.plot_trace(filename=os.path.join(self.output, "trace.png"))
        if close_pool:
            self.ns.model.close_pool()
        return self.logZ, nested_samples

    def run_importance_nested_sampler(
        self,
        plot: bool = True,
        plot_posterior: bool = True,
        save: bool = True,
        posterior_sampling_method: str = "importance_sampling",
        redraw_samples: bool = False,
        n_posterior_samples: Optional[int] = None,
        compute_initial_posterior: bool = False,
        close_pool: Optional[bool] = None,
        **kwargs,
    ):
        """Run the importance nested sampler; returns ``(logZ, samples)``
        with every sample in the model space and sets
        ``posterior_samples``. With ``redraw_samples`` the final redraw
        (:meth:`ImportanceNestedSampler.draw_final_samples`, which takes
        ``kwargs``) runs to a posterior ESS of ``n_posterior_samples``;
        the posterior samples and logZ then come from it, and the
        sampler's estimate stays in ``initial_logZ``. Then the result
        file, the plots and the pool as in
        :meth:`run_standard_sampler`."""
        if close_pool is None:
            close_pool = self.close_pool
        with annotate("initialise"):
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
        if save:
            with annotate("result_write"):
                self.save_results(os.path.join(self.output, "result"), extension=self.result_extension)
        if plot:
            self.ns.produce_plots()
            if plot_posterior:
                from .plot import plot_live_points

                plot_live_points(
                    self.posterior_samples,
                    filename=os.path.join(self.output, "posterior_distribution.png"),
                )
        if close_pool:
            self.ns.model.close_pool()
        return self.logZ, self.nested_samples

    # ------------------------------------------------------------------
    @property
    def result(self) -> dict:
        """The sampler's result dictionary with the posterior samples."""
        if self._result is None:
            from . import __version__

            self._result = self.ns.get_result_dictionary()
            self._result["version"] = __version__
            if hasattr(self, "posterior_samples"):
                self._result["posterior_samples"] = self.posterior_samples
        return self._result

    def save_kwargs(self, kwargs: dict) -> None:
        """Write the sampler's keyword arguments to ``config.json``."""
        save_to_json(
            dict(kwargs, importance_nested_sampler=self.importance_nested_sampler),
            os.path.join(self.output, "config.json"),
        )

    def save_results(self, filename: str, extension: Optional[str] = None) -> None:
        """Save :attr:`result` as JSON (``"json"``) or HDF5 (``"hdf5"``
        or ``"h5"``, needs h5py); the extension is taken from
        ``filename`` where ``extension`` is None."""
        d = dict(self.result)
        if extension is None:
            ext = os.path.splitext(filename)[1].lstrip(".")
            if not ext:
                raise RuntimeError("Must specify an extension in the filename or via the extension argument")
            extension = ext
        elif not filename.endswith(extension):
            filename = filename + "." + extension
        for key in ("nested_samples", "posterior_samples"):
            if key in d and isinstance(d[key], np.ndarray) and d[key].dtype.names:
                d[key] = live_points_to_dict(d[key])
        if extension == "json":
            save_to_json(d, filename)
        elif extension in ("hdf5", "h5"):
            save_dict_to_hdf5(d, filename)
        else:
            raise RuntimeError(f"Unknown extension: {extension}")

    # ------------------------------------------------------------------
    def terminate_run(self, code=None) -> None:
        """Checkpoint and close the pool."""
        logger.warning("Terminating run")
        self.ns.checkpoint(force=True)
        self.ns.model.close_pool(code=code)

    def safe_exit(self, signum=None, frame=None) -> None:
        """Signal handler: checkpoint, then exit with ``exit_code``."""
        logger.warning("Trying to safely exit with code %s", signum)
        self.terminate_run(code=signum)
        sys.exit(self.exit_code)
