"""Shared machinery for flow-based proposals. Counterpart of
``nessai_tpu/proposal/flowproposal/base.py``: owns the FlowModel and the
reparameterisation stack, rescales between x and x', trains the flow and
keeps the pool with an adaptive pool size."""

import logging
import os
from typing import Optional

import numpy as np

from ... import config as global_config
from ...flowmodel import FlowModel
from ...livepoint import empty_structured_array, get_dtype, live_points_to_array
from ...reparameterisations import CombinedReparameterisation, get_reparameterisation
from ...utils.device import get_device
from ..rejection import RejectionProposal

logger = logging.getLogger(__name__)

__all__ = ["BaseFlowProposal"]


class BaseFlowProposal(RejectionProposal):
    """Base class for proposals that sample from a normalising flow
    trained on the current live points."""

    #: cap on the pool-size scale of 1/acceptance
    max_poolsize_scale: float = 10.0
    #: reparameterisation of the parameters that are not given one
    fallback_reparameterisation: str = "zscore"

    def __init__(
        self,
        model,
        flow_config=None,
        training_config=None,
        output: str = "./",
        poolsize: Optional[int] = None,
        rng=None,
        reparameterisations=None,
        device=None,
    ):
        super().__init__(model, rng=rng)
        self.device = get_device(device)
        self._poolsize = int(poolsize if poolsize is not None else 1000)
        self._poolsize_scale = 1.0
        self.ns_acceptance = 1.0
        self.output = output
        self.flow_config = dict(flow_config or {})
        self.training_config = training_config
        self.reparameterisations = reparameterisations
        #: the sampler sets this False when it never checkpoints
        self.save_flow_weights = True

        self.flow: Optional[FlowModel] = None
        self._reparameterisation: Optional[CombinedReparameterisation] = None
        self.parameters = None
        self.prime_parameters = None
        self.populated = False
        self.populated_count = 0
        self.x = None

    @property
    def poolsize(self) -> int:
        return int(self._poolsize * self._poolsize_scale)

    @property
    def dims(self) -> int:
        return len(self.parameters)

    @property
    def prime_dims(self) -> int:
        return len(self.prime_parameters)

    @property
    def x_dtype(self):
        return get_dtype(self.parameters)

    @property
    def x_prime_dtype(self):
        return np.dtype([(p, "f8") for p in self.prime_parameters])

    def update_poolsize_scale(self, acceptance: float) -> None:
        """Scale the poolsize by 1/acceptance, up to ``max_poolsize_scale``."""
        if acceptance is None or acceptance <= 0:
            self._poolsize_scale = self.max_poolsize_scale
        else:
            self._poolsize_scale = min(
                max(1.0, 1.0 / acceptance), float(self.max_poolsize_scale)
            )

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        """Set up the reparameterisations, check that they invert, and
        build the FlowModel."""
        if self.initialised:
            return
        os.makedirs(self.output, exist_ok=True)
        self.set_rescaling()
        self.verify_rescaling()
        flow_config = dict(self.flow_config)
        flow_config["n_inputs"] = self.prime_dims
        self.flow = FlowModel(
            flow_config=flow_config,
            training_config=self.training_config,
            output=self.output,
            rng=self.rng,
            device=self.device,
        )
        self.flow.initialise()
        self.initialised = True

    def configure_reparameterisations(self, reparameterisations) -> None:
        """Build the stack from ``None`` (the fallback for every
        parameter), a name (applied to every parameter) or a dict of
        parameter -> name."""
        self._reparameterisation = CombinedReparameterisation()
        names = list(self.model.names)
        if isinstance(reparameterisations, str):
            reparameterisations = {n: reparameterisations for n in names}
        elif reparameterisations is None:
            reparameterisations = {}
        elif not isinstance(reparameterisations, dict):
            raise TypeError(
                "The PyTorch port takes reparameterisations as None, a "
                "name, or a dict of parameter -> name"
            )
        groups = {}
        for n in names:
            groups.setdefault(
                reparameterisations.get(n, self.fallback_reparameterisation), []
            ).append(n)
        unknown = set(reparameterisations) - set(names)
        if unknown:
            raise RuntimeError(f"{sorted(unknown)} are not parameters of the model")
        for name, parameters in groups.items():
            cls, kwargs = get_reparameterisation(name)
            bounds = {p: np.asarray(self.model.bounds[p], float) for p in parameters}
            self._reparameterisation.add_reparameterisation(
                cls(parameters=parameters, prior_bounds=bounds, rng=self.rng, **kwargs)
            )

    def set_rescaling(self) -> None:
        if self._reparameterisation is None:
            self.configure_reparameterisations(self.reparameterisations)
        self.parameters = list(self.model.names)
        self.prime_parameters = list(self._reparameterisation.prime_parameters)
        logger.info("x-space parameters: %s", self.parameters)
        logger.info("x'-space parameters: %s", self.prime_parameters)

    def verify_rescaling(self) -> None:
        """Check that the reparameterisations round-trip on prior draws."""
        x = self._convert_to_x(self.model.new_point(N=100))
        for _ in range(2):
            self._reparameterisation.update(x)
            x_prime, log_j = self.rescale(x)
            x_out, log_j_inv = self.inverse_rescale(x_prime)
            for n in self.model.names:
                if not np.allclose(x[n], x_out[n], atol=1e-8, equal_nan=True):
                    raise RuntimeError(f"Rescaling is not invertible for {n}")
            if not np.allclose(log_j, -log_j_inv, atol=1e-8):
                raise RuntimeError("Rescaling Jacobian is not invertible")
        self._reparameterisation.reset()

    def _convert_to_x(self, points):
        if points.dtype == self.x_dtype:
            return points
        out = empty_structured_array(len(points), dtype=self.x_dtype)
        for n in points.dtype.names:
            if n in out.dtype.names:
                out[n] = points[n]
        return out

    def rescale(self, x):
        """x -> (x', log|dx'/dx|)."""
        x_prime = np.zeros(len(x), dtype=self.x_prime_dtype)
        log_j = np.zeros(len(x))
        _, x_prime, log_j = self._reparameterisation.reparameterise(x.copy(), x_prime, log_j)
        return x_prime, log_j

    def inverse_rescale(self, x_prime):
        """x' -> (x, log|dx/dx'|)."""
        x = empty_structured_array(len(x_prime), dtype=self.x_dtype)
        log_j = np.zeros(len(x_prime))
        x, _, log_j = self._reparameterisation.inverse_reparameterise(x, x_prime, log_j)
        return x, log_j

    # ------------------------------------------------------------------
    def train(self, x) -> None:
        """Fit the reparameterisations to ``x`` and train the flow on
        their output."""
        if not self.initialised:
            raise RuntimeError("Proposal must be initialised before training")
        x = self._convert_to_x(np.asarray(x).copy())
        self._reparameterisation.update(x)
        x_prime, _ = self.rescale(x)
        x_prime = live_points_to_array(x_prime, self.prime_parameters)
        self.flow.train(x_prime, save=self.save_flow_weights)
        self.training_count += 1
        self.populated = False

    # ------------------------------------------------------------------
    def log_prior(self, x):
        return self.model.batch_evaluate_log_prior(x) + self._reparameterisation.log_prior(x)

    def compute_weights(self, x, log_q):
        """logW = logP - logQ."""
        log_p = self.log_prior(x)
        x["logP"] = log_p
        return log_p - log_q

    def convert_to_samples(self, x):
        """Model-space samples with the log-prior set."""
        out = empty_structured_array(len(x), names=self.model.names)
        for n in self.model.names:
            out[n] = x[n]
        for f in global_config.livepoints.non_sampling_parameters:
            out[f] = x[f]
        out["logP"] = self.model.batch_evaluate_log_prior(out)
        return out

    def populate(self, worst_point, n_samples=10000):
        raise NotImplementedError

    def draw(self, worst_point):
        """Pop a sample from the pool, repopulating (with the adaptive
        poolsize) when empty."""
        if not self.populated:
            self.update_poolsize_scale(self.ns_acceptance)
            while not self.populated:
                self.populate(worst_point, n_samples=self.poolsize)
        index = self.indices.pop()
        new_sample = self.samples[index]
        if not self.indices:
            self.populated = False
        return new_sample
