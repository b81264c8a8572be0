"""Flows of the importance nested sampler: one per level. Counterpart of
``nessai_tpu/flowmodel/importance.py``.

Each level is a frozen copy of the :class:`~nessai_tpu_torch.flows.Flow`
that :class:`~nessai_tpu_torch.flowmodel.FlowModel` trained for it, kept
on the device. ``log_prob_all`` runs one ``Flow.log_prob`` per level (on
the GPU, through the affine-coupling kernel) and copies the stacked
``[n, levels]`` result to the host once; the JAX package's stacked,
vmapped program and its level and row padding are TPU workarounds and
are not carried over. Inputs go to the flows as float32, log-densities
come back as float64, as in the JAX package.
"""

import copy
import datetime
import logging
from typing import List

import numpy as np
import torch

from ..flows import Flow
from ..flows.utils import reset_weights
from .base import FlowModel
from .config import flow_config_to_dict

logger = logging.getLogger(__name__)

__all__ = ["ImportanceFlowModel"]


class ImportanceFlowModel(FlowModel):
    """A :class:`FlowModel` that keeps a list of trained levels.

    ``self.flow`` is the level in training; :meth:`train` freezes a copy
    of it onto :attr:`models`. Fresh weights (:meth:`add_new_flow` with
    ``reset``) and the latent draws of :meth:`sample_and_log_prob_ith`
    come from ``torch.Generator`` objects seeded from ``rng``.
    """

    def __init__(self, flow_config=None, training_config=None, output=None, rng=None, device=None):
        super().__init__(
            flow_config=flow_config,
            training_config=training_config,
            output=output,
            rng=rng,
            device=device,
        )
        self.models: List[Flow] = []
        #: wall time in :meth:`log_prob_all`
        self.log_prob_all_time = datetime.timedelta()
        self._weights_generator = None
        self._sample_generator = None

    @property
    def n_models(self) -> int:
        return len(self.models)

    def initialise(self) -> None:
        if self.initialised:
            return
        super().initialise()
        self._weights_generator = torch.Generator().manual_seed(
            int(self.rng.integers(0, 2**63 - 1))
        )
        self._sample_generator = torch.Generator(device=self.device).manual_seed(
            int(self.rng.integers(0, 2**63 - 1))
        )

    # ------------------------------------------------------------------
    def add_new_flow(self, reset: bool = False) -> None:
        """Start a new level: fresh weights (``reset``, and always for the
        first level), whose ActNorm layers then take their data
        initialisation again, or the weights of the latest level."""
        if not self.initialised:
            self.initialise()
        if reset or not self.models:
            reset_weights(self.flow, flow_config_to_dict(self.flow_config), self._weights_generator)
            self._actnorm_done = False
        else:
            self.flow.load_state_dict(self.models[-1].state_dict())
            self._actnorm_done = True
        self.reset_optimiser()

    def add_level(self, flow: Flow) -> None:
        """Freeze a copy of ``flow`` as the next level."""
        level = copy.deepcopy(flow).requires_grad_(False)
        self.models.append(level.eval())

    def train(self, samples, weights=None, **kwargs):
        """Train the current level on ``samples`` (with the weighted loss
        where ``weights`` are given) and freeze it onto the list. The
        per-level weight files wait with checkpointing."""
        history = super().train(samples, weights=weights, save=False, **kwargs)
        self.add_level(self.flow)
        return history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def log_prob_all(self, x) -> np.ndarray:
        """``[n, n_models]`` float64 log-density of every row of ``x``
        under every level: one flow forward per level on the device and
        one copy to the host."""
        if not self.models:
            return np.empty((len(x), 0))
        st = datetime.datetime.now()
        x = self._to_device(x)
        out = torch.stack([flow.log_prob(x) for flow in self.models], dim=1)
        out = out.double().cpu().numpy()
        self.log_prob_all_time += datetime.datetime.now() - st
        return out

    @torch.no_grad()
    def log_prob_ith(self, x, i: int) -> np.ndarray:
        """Float64 log-density of every row of ``x`` under level ``i``."""
        return self.models[i].log_prob(self._to_device(x)).double().cpu().numpy()

    @torch.no_grad()
    def sample_and_log_prob_ith(self, i: int, N: int = 1):
        """``N`` draws from level ``i`` and their log-density, as float64
        host arrays: latent normals from the device generator, mapped
        through the level's inverse on the device."""
        z = torch.randn(
            int(N), self.dims, generator=self._sample_generator, device=self.device
        )
        x, log_prob = self.models[i].inverse_and_log_prob(z)
        return x.double().cpu().numpy(), log_prob.double().cpu().numpy()

    def sample_ith(self, i: int, N: int = 1) -> np.ndarray:
        """``N`` draws from level ``i`` (float64 host array)."""
        return self.sample_and_log_prob_ith(i, N)[0]
