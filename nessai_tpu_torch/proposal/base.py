"""Proposal base class. Counterpart of ``nessai_tpu/proposal/base.py``."""

import datetime
from abc import ABC, abstractmethod

import numpy as np

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
