"""Base nested sampler: RNG seeding, output directory and periodic
logging. Counterpart of ``nessai_tpu/samplers/base.py`` without
checkpointing and resume."""

import datetime
import logging
import os
import random
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

from ..utils.device import get_device

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
        device=None,
    ):
        self.device = get_device(device)
        self.model = model
        self.model.device = self.device
        self.nlive = int(nlive)
        self.configure_rng(seed=seed, rng=rng)
        if self.model.rng is None:
            self.model.set_rng(self.rng)
        self.model.verify_model()
        self.iteration = 0
        self.sampling_start_time = datetime.datetime.now()
        self.sampling_time = datetime.timedelta()
        self.finalised = False
        self.history = None
        if output is None:
            output = os.getcwd()
        os.makedirs(output, exist_ok=True)
        self.output = output
        self._last_log = 0

    def configure_rng(self, seed=None, rng=None) -> None:
        """Seed the host RNG; every random draw of the run comes from it."""
        if seed is None:
            if rng is None:
                seed = random.randint(0, 2**32 - 1)
            else:
                seed = int(rng.integers(0, 2**32 - 1))
        self.seed = seed
        self.rng = rng if rng is not None else np.random.default_rng(self.seed)

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

    def initialise_history(self) -> None:
        if self.history is None:
            self.history = dict(iterations=[], sampling_time=[], likelihood_evaluations=[])

    def update_history(self) -> None:
        self.history["iterations"].append(self.iteration)
        self.history["sampling_time"].append(self.current_sampling_time.total_seconds())
        self.history["likelihood_evaluations"].append(self.total_likelihood_evaluations)

    def periodically_log_state(self) -> None:
        """Log the state every ``nlive`` iterations."""
        if (self.iteration - self._last_log) < self.nlive:
            return
        self._last_log = self.iteration
        self.log_state()

    def log_state(self) -> None:
        logger.info("it: %s", self.iteration)

    @abstractmethod
    def nested_sampling_loop(self):
        raise NotImplementedError
