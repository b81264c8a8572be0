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

On a device mesh every level trains data-parallel (``FlowModel.train``)
and is frozen with one copy a further mesh entry; ``log_prob_all`` cuts
its rows over the mesh and runs every level on each shard, and a
level's draws are inverted shard by shard.
"""

import copy
import datetime
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from ..flows import Flow
from ..flows.utils import reset_weights
from .base import WEIGHTS_FILE, FlowModel, _cpu_state_dict
from .config import flow_config_to_dict, update_flow_config, update_training_config

logger = logging.getLogger(__name__)

__all__ = ["ImportanceFlowModel"]


class ImportanceFlowModel(FlowModel):
    """A :class:`FlowModel` that keeps a list of trained levels.

    ``self.flow`` is the level in training; :meth:`train` freezes a copy
    of it onto :attr:`models`. Fresh weights (:meth:`add_new_flow` with
    ``reset``) and the latent draws of :meth:`sample_and_log_prob_ith`
    come from ``torch.Generator`` objects seeded from ``rng``. Each
    trained level is saved to ``output/level_<i>/model.pt``; a pickle
    holds no level, and :meth:`resume` reloads them from those files.
    """

    _generators = FlowModel._generators + ("_weights_generator", "_sample_generator")
    #: no mesh: the default of a model unpickled from before meshes
    _level_replicas = ()

    def __init__(self, flow_config=None, training_config=None, output=None, rng=None, device=None, mesh=None):
        super().__init__(
            flow_config=flow_config,
            training_config=training_config,
            output=output,
            rng=rng,
            device=device,
            mesh=mesh,
        )
        self.models: List[Flow] = []
        #: each level's copies on ``mesh.devices[1:]``, level by level
        self._level_replicas: List[list] = []
        #: wall time in :meth:`log_prob_all`
        self.log_prob_all_time = datetime.timedelta()
        self._weights_generator = None
        self._sample_generator = None
        #: the weights file of every level (None where none was saved)
        self.weights_files: List[Optional[str]] = []

    @property
    def n_models(self) -> int:
        return len(self.models)

    @property
    def model(self) -> Optional[Flow]:
        """The latest level, or None before the first."""
        return self.models[-1] if self.models else None

    @model.setter
    def model(self, model: Optional[Flow]) -> None:
        """Add ``model`` as the next level (None adds nothing)."""
        if model is not None:
            self.add_level(model)

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
        self.refresh_replicas()
        self.reset_optimiser()

    def add_level(self, flow: Flow) -> None:
        """Freeze a copy of ``flow`` as the next level."""
        level = copy.deepcopy(flow).requires_grad_(False)
        self.models.append(level.eval())
        if self.mesh is not None:
            self._level_replicas.append([copy.deepcopy(level).to(d) for d in self.mesh.devices[1:]])

    def level_replicas(self, i: int) -> list:
        """Level ``i`` and its copies, one a mesh entry."""
        return [self.models[i]] + (list(self._level_replicas[i]) if self.mesh is not None else [])

    def train(self, samples, weights=None, **kwargs):
        """Train the current level on ``samples`` (with the weighted loss
        where ``weights`` are given), freeze it onto the list and save
        its weights to ``output/level_<i>/model.pt``."""
        kwargs.pop("output", None)
        history = super().train(samples, weights=weights, **kwargs)
        self.add_level(self.flow)
        if self.output is not None:
            path = self._level_file(self.output, self.n_models - 1)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(_cpu_state_dict(self.models[-1]), path)
            self.weights_files.append(path)
        else:
            self.weights_files.append(None)
        return history

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    @staticmethod
    def _level_file(output: str, i: int) -> str:
        return os.path.join(output, f"level_{i}", WEIGHTS_FILE)

    def save_all_weights(self) -> None:
        """Save every level's weights to ``output/level_<i>/model.pt``."""
        for i, level in enumerate(self.models):
            path = self._level_file(self.output, i)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(_cpu_state_dict(level), path)

    def load_all_weights(self, output: Optional[str] = None) -> None:
        """Rebuild the levels on :attr:`device` from
        ``output/level_<i>/model.pt``, for i = 0, 1, ... while the files
        exist."""
        if output is None:
            output = self.output
        if not self.initialised:
            self.initialise()
        self.models = []
        self._level_replicas = []
        while os.path.exists(path := self._level_file(output, self.n_models)):
            self.flow.load_state_dict(torch.load(path, map_location=self.device, weights_only=True))
            self.add_level(self.flow)
        logger.info("Reloaded %d flow levels", self.n_models)

    def update_weights_path(self, weights_path: str, n=None) -> None:
        """Save the levels under ``weights_path`` from now on (``n`` is
        accepted and unused, as in the JAX package)."""
        self.output = weights_path

    def resume(self, flow_config=None, training_config=None, weights_path=None) -> None:
        """Rebuild the levels from their weight files in
        ``weights_path`` (by default :attr:`output`)."""
        if flow_config is not None:
            self.flow_config = update_flow_config(flow_config)
        if training_config is not None:
            self.training_config = update_training_config(training_config)
        self.initialise()
        self.load_all_weights(weights_path or self.output)

    def __getstate__(self):
        """Levels are kept as weight files, not in the pickle; the
        generators' states go in as CPU byte tensors with their devices."""
        state = super().__getstate__()
        state["models"] = []
        state["_level_replicas"] = []
        return state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def log_prob_all(self, x) -> np.ndarray:
        """``[n, n_models]`` float64 log-density of every row of ``x``
        under every level: one flow forward per level on the device and
        one copy to the host."""
        if not self.models:
            return np.empty((len(x), 0))
        st = datetime.datetime.now()
        # each entry runs every level's copy on its shard
        levels = [self.level_replicas(i) for i in range(self.n_models)]
        by_entry = [list(entry) for entry in zip(*levels)]
        out = self.sharded(
            lambda levels_r, a: torch.stack([f.log_prob(a) for f in levels_r], dim=1),
            np.asarray(x, np.float32),
            flows=by_entry,
        )
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
        host arrays: latent draws from the level's base distribution (one
        ``torch.randn`` for a unit Gaussian) on the device generator,
        mapped through the level's inverse on the device."""
        z = self.models[i].sample_base(int(N), self._sample_generator)
        x, log_prob = self.sharded(lambda f, a: f.inverse_and_log_prob(a), z, flows=self.level_replicas(i))
        return x.double().cpu().numpy(), log_prob.double().cpu().numpy()

    def sample_ith(self, i: int, N: int = 1) -> np.ndarray:
        """``N`` draws from level ``i`` (float64 host array)."""
        return self.sample_and_log_prob_ith(i, N)[0]
