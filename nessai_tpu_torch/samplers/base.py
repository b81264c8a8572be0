"""Base nested sampler: RNG seeding, output directory, periodic logging
and checkpointing, and resume from a pickle. Counterpart of
``nessai_tpu/samplers/base.py``.

A checkpoint is the pickled sampler without its model. It holds no
CUDA object: the flows are saved as weight files and rebuilt on the
sampler's device at resume (:meth:`BaseNestedSampler.resume`)."""

import datetime
import logging
import os
import pickle
import random
import time
from abc import ABC, abstractmethod
from typing import Callable, Optional

import numpy as np

from ..utils.device import get_device
from ..utils.io import safe_file_dump
from ..utils.profiling import annotate

logger = logging.getLogger(__name__)

__all__ = ["BaseNestedSampler"]


class BaseNestedSampler(ABC):
    """Common scaffolding of the nested samplers."""

    def __init__(
        self,
        model,
        nlive: int,
        output: Optional[str] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        checkpointing: bool = True,
        checkpoint_interval: int = 600,
        checkpoint_on_iteration: bool = False,
        checkpoint_callback: Optional[Callable] = None,
        logging_interval: Optional[int] = None,
        log_on_iteration: bool = True,
        resume_file: Optional[str] = None,
        plot: bool = True,
        n_pool: Optional[int] = None,
        pool=None,
        device=None,
    ):
        self.device = get_device(device)
        self.model = model
        self.model.device = self.device
        self.nlive = int(nlive)
        self.plot = plot
        self.checkpointing = checkpointing
        self.checkpoint_interval = checkpoint_interval
        self.checkpoint_on_iteration = checkpoint_on_iteration
        self.checkpoint_callback = checkpoint_callback
        self._last_checkpoint_time = time.time()
        self._last_checkpoint_iteration = 0
        self.configure_rng(seed=seed, rng=rng)
        if self.model.rng is None:
            self.model.set_rng(self.rng)
        self.model.verify_model()
        self.n_pool = n_pool
        if pool is not None or n_pool is not None:
            self.model.configure_pool(pool=pool, n_pool=n_pool)
        self.iteration = 0
        self.sampling_start_time = datetime.datetime.now()
        self.sampling_time = datetime.timedelta()
        self.finalised = False
        self.history = None
        self.output = self.configure_output(output, resume_file)
        self.configure_periodic_logging(logging_interval, log_on_iteration)

    def configure_rng(self, seed=None, rng=None) -> None:
        """Seed the host RNG; every random draw of the run comes from it."""
        if seed is None:
            if rng is None:
                seed = random.randint(0, 2**32 - 1)
            else:
                seed = int(rng.integers(0, 2**32 - 1))
        self.seed = seed
        self.rng = rng if rng is not None else np.random.default_rng(self.seed)

    def configure_output(self, output, resume_file=None) -> str:
        """Make the output directory (by default the working directory)
        and set :attr:`resume_file` in it."""
        if output is None:
            output = os.getcwd()
        os.makedirs(output, exist_ok=True)
        self.resume_file = os.path.join(output, resume_file or "nested_sampler_resume.pkl")
        return output

    def update_output(self, output: str) -> None:
        """Move the output directory and the resume file into it."""
        self.output = output
        os.makedirs(output, exist_ok=True)
        self.resume_file = os.path.join(output, os.path.basename(self.resume_file))

    def configure_periodic_logging(self, logging_interval, log_on_iteration) -> None:
        """Log every ``logging_interval`` iterations (by default
        ``nlive``) or, without ``log_on_iteration``, every
        ``logging_interval`` seconds; with both off, log on iteration."""
        self.logging_interval = logging_interval
        self.log_on_iteration = log_on_iteration
        if not self.logging_interval and not self.log_on_iteration:
            logger.warning("All logging disabled. Enabling logging on iteration")
            self.log_on_iteration = True
        if self.log_on_iteration:
            if self.logging_interval is None:
                self.logging_interval = self.nlive
            self._last_log = 0
        else:
            self._last_log = time.time()

    @property
    def current_sampling_time(self):
        if self.finalised:
            return self.sampling_time
        return self.sampling_time + (datetime.datetime.now() - self.sampling_start_time)

    @property
    def likelihood_evaluation_time(self):
        return self.model.likelihood_evaluation_time

    @property
    def total_likelihood_evaluations(self):
        return self.model.likelihood_evaluations

    @property
    def likelihood_calls(self):
        return self.model.likelihood_evaluations

    @property
    def posterior_effective_sample_size(self):
        """Defined by each sampler."""
        raise NotImplementedError()

    def initialise_history(self) -> None:
        if self.history is None:
            self.history = dict(
                iterations=[],
                sampling_time=[],
                likelihood_evaluations=[],
                checkpoint_iterations=[],
            )

    def update_history(self) -> None:
        self.history["iterations"].append(self.iteration)
        self.history["sampling_time"].append(self.current_sampling_time.total_seconds())
        self.history["likelihood_evaluations"].append(self.total_likelihood_evaluations)

    def periodically_log_state(self) -> None:
        """Log by iteration count or wall time."""
        if self.log_on_iteration:
            if (self.iteration - self._last_log) < self.logging_interval:
                return
            self._last_log = self.iteration
        else:
            now = time.time()
            if (now - self._last_log) < (self.logging_interval or 60):
                return
            self._last_log = now
        self.log_state()

    def log_state(self) -> None:
        logger.info("it: %s", self.iteration)

    # ------------------------------------------------------------------
    # Checkpoint and resume
    # ------------------------------------------------------------------
    def checkpoint(self, periodic: bool = False, force: bool = False, save_existing: Optional[bool] = None) -> None:
        """Pickle the sampler to :attr:`resume_file` (through a temporary
        file), or hand it to ``checkpoint_callback``.

        A periodic checkpoint is written only with ``checkpointing`` and
        once ``checkpoint_interval`` seconds (iterations, with
        ``checkpoint_on_iteration``) have passed since the last; ``force``
        writes at once. A checkpoint that is not periodic is marked in
        the history. With ``save_existing`` (by default
        ``save_existing_checkpoint``, else True) the previous file moves
        to ``<file>.old``. A checkpoint written is traced as the span
        ``checkpoint``.
        """
        if not force:
            if not self.checkpointing:
                return
            if periodic:
                if self.checkpoint_on_iteration:
                    due = (self.iteration - self._last_checkpoint_iteration) >= self.checkpoint_interval
                else:
                    due = (time.time() - self._last_checkpoint_time) >= self.checkpoint_interval
                if not due:
                    return
        if not periodic:
            if self.history is not None:
                self.history.setdefault("checkpoint_iterations", []).append(self.iteration)
            else:
                logger.warning("Could not log checkpoint iteration in the history")
        st = datetime.datetime.now()
        self.sampling_time += st - self.sampling_start_time
        logger.info("Checkpointing nested sampling")
        with annotate("checkpoint"):
            if self.checkpoint_callback is not None:
                self.checkpoint_callback(self)
            else:
                if save_existing is None:
                    save_existing = getattr(self, "save_existing_checkpoint", True)
                safe_file_dump(self, self.resume_file, module=pickle, save_existing=save_existing)
        self.sampling_start_time = datetime.datetime.now()
        self._last_checkpoint_time = time.time()
        self._last_checkpoint_iteration = self.iteration

    @classmethod
    def resume_from_pickled_sampler(
        cls,
        sampler,
        model,
        output=None,
        checkpoint_callback=None,
        rng=None,
        device=None,
        **kwargs,
    ):
        """Rebind ``model`` to an unpickled sampler, carrying its
        likelihood counters over. ``output`` moves the run to a new
        directory; ``device`` (default CUDA) is where its flows are
        rebuilt, whatever device wrote the checkpoint."""
        logger.info("Resuming sampler at iteration %s", sampler.iteration)
        sampler.device = get_device(device)
        model.device = sampler.device
        model.likelihood_evaluations += sampler._previous_likelihood_evaluations
        model.likelihood_evaluation_time += datetime.timedelta(
            seconds=sampler._previous_likelihood_evaluation_time
        )
        if output is not None and output != sampler.output:
            logger.info("Overwriting output from %s to %s", sampler.output, output)
            os.makedirs(output, exist_ok=True)
            sampler.update_output(output)
        sampler.checkpoint_callback = checkpoint_callback
        sampler.model = model
        if rng is not None:
            sampler.rng = rng
        if sampler.model.rng is None:
            sampler.model.set_rng(sampler.rng)
        sampler.sampling_start_time = datetime.datetime.now()
        return sampler

    @classmethod
    def resume(cls, filename, model, output=None, rng=None, device=None, **kwargs):
        """Load a pickled sampler and rebind ``model`` (see
        :meth:`resume_from_pickled_sampler`)."""
        logger.info("Resuming sampler from %s", filename)
        device = get_device(device)
        with open(filename, "rb") as f:
            sampler = pickle.load(f)
        return cls.resume_from_pickled_sampler(sampler, model, output=output, rng=rng, device=device, **kwargs)

    def close_pool(self, code=None) -> None:
        """Close the model's pool of worker processes."""
        self.model.close_pool(code=code)

    def get_result_dictionary(self) -> dict:
        """Run summary for the result file."""
        from .. import __version__

        d = dict(
            version=__version__,
            seed=self.seed,
            sampling_time=self.sampling_time.total_seconds(),
            total_likelihood_evaluations=self.total_likelihood_evaluations,
            likelihood_evaluation_time=self.likelihood_evaluation_time.total_seconds(),
            history=self.history,
        )
        if hasattr(self.model, "truth"):
            d["truth"] = self.model.truth
        return d

    @abstractmethod
    def nested_sampling_loop(self):
        raise NotImplementedError

    def __getstate__(self):
        """The model and the checkpoint callback stay out of the pickle;
        the model's likelihood counters go in."""
        d = self.__dict__
        state = {k: d[k] for k in d.keys() - {"model", "checkpoint_callback"}}
        model = d.get("model")
        state["_previous_likelihood_evaluations"] = model.likelihood_evaluations if model else 0
        state["_previous_likelihood_evaluation_time"] = (
            model.likelihood_evaluation_time.total_seconds() if model else 0.0
        )
        return state
