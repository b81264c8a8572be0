"""Proposal base class. Counterpart of ``nessai_tpu/proposal/base.py``."""

import datetime
import logging
import os
from abc import ABC, abstractmethod

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["Proposal"]


class Proposal(ABC):
    """Base object for proposals: ``draw(old_point)`` returns a new
    sample. Tracks the population wall-time."""

    def __init__(self, model, rng=None):
        self.model = model
        self.rng = rng if rng is not None else np.random.default_rng()
        self.populated = True
        self._initialised = False
        self.training_count = 0
        self.population_acceptance = None
        self.population_time = datetime.timedelta()
        self.samples = []
        self.indices = []

    @property
    def initialised(self) -> bool:
        return self._initialised

    @initialised.setter
    def initialised(self, boolean: bool):
        self._initialised = bool(boolean)

    def initialise(self) -> None:
        self.initialised = True

    @abstractmethod
    def draw(self, old_param):
        raise NotImplementedError

    def train(self, x) -> None:
        """This proposal cannot be trained."""

    def update_output(self, output: str) -> None:
        """Move the proposal's output directory, if it has one."""
        if hasattr(self, "output"):
            self.output = output
            os.makedirs(self.output, exist_ok=True)

    def resume(self, model) -> None:
        """Rebind the model after unpickling."""
        self.model = model

    def evaluate_likelihoods(self) -> None:
        """The model's log-likelihood of every sample of the pool."""
        self.samples["logL"] = self.model.batch_evaluate_log_likelihood(self.samples)

    def reset(self) -> None:
        """Drop the pool."""
        self.samples = []
        self.indices = []
        self.populated = False

    def __getstate__(self):
        """The model stays out of the pickle (the sampler rebinds it at
        resume)."""
        state = self.__dict__.copy()
        state["model"] = None
        return state
