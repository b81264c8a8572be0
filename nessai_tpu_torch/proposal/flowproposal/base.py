"""Shared machinery for flow-based proposals. Counterpart of
``nessai_tpu/proposal/flowproposal/base.py``: owns the FlowModel and the
reparameterisation stack (built from the user's spec), rescales between
x and x' (on the prior's unit hypercube with ``map_to_unit_hypercube``),
trains the flow, passes points through it (``forward_pass``,
``backward_pass``) and keeps the pool with an adaptive pool size."""

import inspect
import logging
import os
import warnings
from typing import Optional

import numpy as np

from ... import config as global_config
from ...flowmodel import FlowModel
from ...livepoint import empty_structured_array, get_dtype, live_points_to_array
from ...reparameterisations import (
    CombinedReparameterisation,
    NullReparameterisation,
    get_reparameterisation,
    parse_reparameterisations,
    resolve_reparameterisation_parameters,
)
from ...utils.device import get_device
from ..rejection import RejectionProposal

logger = logging.getLogger(__name__)

__all__ = ["BaseFlowProposal"]


class BaseFlowProposal(RejectionProposal):
    """Base class for proposals that sample from a normalising flow
    trained on the current live points.

    ``check_acceptance`` records, after each populate, the share of the
    pool above the worst point's likelihood; the pool size is scaled by
    the sampler's 1/acceptance up to ``max_poolsize_scale`` where
    ``update_poolsize``; ``save_training_data`` saves each training set;
    ``map_to_unit_hypercube`` runs the reparameterisations and the flow
    on the prior's unit hypercube; ``accept_all`` keeps every draw that
    survives the truncation (no rejection sampling); ``mesh`` (a
    :class:`~nessai_tpu_torch.parallel.Mesh`) puts the flow model on a
    device mesh (``nessai_tpu/proposal/flowproposal/base.py:93,280``).
    """

    #: whether :meth:`add_default_reparameterisations` is applied;
    #: subclasses may flip this
    use_default_reparameterisations = False
    #: no mesh: the default of a proposal unpickled from before meshes
    mesh = None

    def __init__(
        self,
        model,
        flow_config=None,
        training_config=None,
        output: str = "./",
        poolsize: Optional[int] = None,
        rng=None,
        check_acceptance: bool = False,
        max_poolsize_scale: int = 10,
        update_poolsize: bool = True,
        save_training_data: bool = False,
        reparameterisations=None,
        fallback_reparameterisation: Optional[str] = "zscore",
        use_default_reparameterisations: Optional[bool] = None,
        reverse_reparameterisations: bool = False,
        map_to_unit_hypercube: bool = False,
        accept_all: bool = False,
        plot="min",
        device=None,
        mesh=None,
    ):
        super().__init__(model, rng=rng)
        self.device = get_device(device)
        #: the device mesh the flow trains and runs on (None: one device)
        self.mesh = mesh
        self.configure_poolsize(poolsize if poolsize is not None else 1000, update_poolsize, max_poolsize_scale)
        self.ns_acceptance = 1.0
        self.output = output
        self.flow_config = dict(flow_config or {})
        self.training_config = training_config
        self.check_acceptance = check_acceptance
        self.save_training_data = save_training_data
        self.map_to_unit_hypercube = map_to_unit_hypercube
        self.accept_all = accept_all
        self.reparameterisations = reparameterisations
        if use_default_reparameterisations is not None:
            self.use_default_reparameterisations = use_default_reparameterisations
        #: reparameterisation of the parameters that no spec covers (None:
        #: the identity)
        self.fallback_reparameterisation = fallback_reparameterisation
        self.reverse_reparameterisations = reverse_reparameterisations
        self.use_x_prime_prior = False
        #: the sampler sets this False when it never checkpoints
        self.save_flow_weights = True
        self.configure_plotting(plot)

        self.flow: Optional[FlowModel] = None
        self._reparameterisation: Optional[CombinedReparameterisation] = None
        self.parameters = None
        self.prime_parameters = None
        self.acceptance = []
        self.populated = False
        self.populated_count = 0
        self.training_data = None
        #: the training data's forward images and their log q, kept where
        #: a truncation rule reads them
        self.training_latent = None
        self.training_log_q = None
        self.x = None

    def configure_poolsize(self, poolsize, update_poolsize, max_poolsize_scale) -> None:
        if poolsize is None:
            raise RuntimeError("Must specify `poolsize`")
        self._poolsize = int(poolsize)
        self._poolsize_scale = 1.0
        self.update_poolsize = update_poolsize
        self.max_poolsize_scale = max_poolsize_scale

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

    @property
    def rescaled_dims(self) -> int:
        """Deprecated: :attr:`prime_dims`."""
        warnings.warn(
            "rescaled_dims is deprecated and will be removed in a future release, use prime_dims instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.prime_dims

    @property
    def population_dtype(self):
        return get_dtype(self.parameters)

    @property
    def internal_prime_parameters(self):
        """The prime parameters with any intermediate ones; every prime
        parameter is the flow's, so these are :attr:`prime_parameters`."""
        return self.prime_parameters

    @property
    def x_prime_internal_dtype(self):
        return self.x_prime_dtype

    @property
    def flow_dims(self) -> int:
        return self.prime_dims

    def latent_log_prob(self, z, temperature=None):
        """The log-density of latent points ``z`` under the base
        distribution, tempered at ``temperature`` where it is not 1."""
        return self.flow.base_log_prob(z, temperature=temperature)

    def sample_latent_distribution(self, n: int) -> np.ndarray:
        """``n`` draws from the latent distribution."""
        return self.flow.sample_latent_distribution(n)

    def reset_model_weights(self, weights: bool = True, permutations: bool = False) -> None:
        """Fresh weights and/or permutations for the flow."""
        self.flow.reset_model(weights=weights, permutations=permutations)

    def check_prior_bounds(self, x, *arrays):
        """The points of ``x`` inside the prior bounds (the unit hypercube
        with ``map_to_unit_hypercube``), with the same rows of each of
        ``arrays``."""
        keep = self.model.in_unit_hypercube(x) if self.map_to_unit_hypercube else self.model.in_bounds(x)
        out = [x[keep]] + [a[keep] for a in arrays]
        return out[0] if not arrays else tuple(out)

    def update_poolsize_scale(self, acceptance: float) -> None:
        """Scale the poolsize by 1/acceptance, up to ``max_poolsize_scale``."""
        if acceptance is None or acceptance <= 0:
            self._poolsize_scale = self.max_poolsize_scale
        else:
            self._poolsize_scale = min(
                max(1.0, 1.0 / acceptance), float(self.max_poolsize_scale)
            )

    def configure_plotting(self, plot) -> None:
        """``plot``: ``"all"`` (or ``"train"``/``"pool"`` for one of
        them) or any other truthy value plots the training loss and each
        pool; False plots nothing."""
        if plot in ("all", "train", "pool"):
            self._plot_training = plot in ("all", "train")
            self._plot_pool = plot in ("all", "pool")
        elif isinstance(plot, str) and plot not in ("min", "minimal"):
            logger.warning("Unknown plot argument: %s, setting all false", plot)
            self._plot_training = self._plot_pool = False
        else:
            self._plot_training = self._plot_pool = bool(plot)

    # ------------------------------------------------------------------
    def initialise(self, resumed: bool = False) -> None:
        """Set up the reparameterisations, check that they invert (not
        at resume, where they hold their fitted state), and build the
        FlowModel."""
        if self.initialised:
            return
        os.makedirs(self.output, exist_ok=True)
        self.set_rescaling()
        if not resumed:
            self.verify_rescaling()
        flow_config = dict(self.flow_config)
        flow_config["n_inputs"] = self.prime_dims
        flow_config = self.update_flow_config(flow_config)
        self.flow = self.make_flow_model(flow_config)
        self.flow.initialise()
        self.initialised = True

    def make_flow_model(self, flow_config: dict) -> FlowModel:
        """The proposal's flow model on :attr:`device` (subclass hook: the
        clustering proposal's is conditional)."""
        return FlowModel(
            flow_config=flow_config,
            training_config=self.training_config,
            output=self.output,
            rng=self.rng,
            device=self.device,
            mesh=self.mesh,
        )

    def update_flow_config(self, flow_config: dict) -> dict:
        """Hook for subclasses to adjust the flow config (the augmented
        proposal's fixed coupling mask)."""
        return flow_config

    def add_default_reparameterisations(self) -> None:
        """Hook for subclasses to add reparameterisations that are assumed
        by default; applied after the user's specs when
        :attr:`use_default_reparameterisations` is True."""
        logger.debug("No default reparameterisations")

    @property
    def prior_bounds(self):
        if self.map_to_unit_hypercube:
            return {n: np.array([0.0, 1.0]) for n in self.model.names}
        return {n: np.asarray(self.model.bounds[n], float) for n in self.model.names}

    def get_reparameterisation(self, name):
        """The reparameterisation class and keyword arguments of ``name``
        (subclass hook)."""
        return get_reparameterisation(name)

    def _get_prior_bounds_for_parameters(self, parameters):
        """Prior bounds restricted to model parameters (None if empty)."""
        bounds = self.prior_bounds
        if isinstance(parameters, list):
            prior_bounds = {p: bounds[p] for p in parameters if p in bounds}
        elif parameters in bounds:
            prior_bounds = {parameters: bounds[parameters]}
        else:
            prior_bounds = {}
        return prior_bounds or None

    def get_reparameterisation_from_spec(self, spec):
        """Resolve a :class:`ReparameterisationSpec` to (class, config)."""
        try:
            rc, config = self.get_reparameterisation(spec.reparameterisation)
        except ValueError:
            raise RuntimeError(
                f"{spec.source_key} is not a parameter in the model or a known reparameterisation"
            )
        config.update(spec.kwargs)

        if spec.source_is_parameter:
            config["parameters"] = spec.input_parameters
        else:
            parameters = resolve_reparameterisation_parameters(
                spec.input_parameters,
                available_parameters=list(
                    dict.fromkeys(
                        list(self.model.names)
                        + list(self._reparameterisation.parameters)
                        + list(self._reparameterisation.prime_parameters)
                    )
                ),
            )
            if parameters is not None:
                config["parameters"] = parameters
            else:
                logger.warning("Reparameterisation might be missing input parameters!")

        # accept both spellings from user kwargs
        if "input_parameters" in config:
            config["parameters"] = config.pop("input_parameters")
        if not config.get("parameters"):
            raise RuntimeError(
                "No input_parameters key in the config! Check reparameterisations, "
                "setting logging level to DEBUG can be helpful"
            )
        return rc, config

    def instantiate_reparameterisation_from_spec(self, spec):
        """Instantiate a reparameterisation from a spec."""
        rc, config = self.get_reparameterisation_from_spec(spec)
        config.setdefault("prior_bounds", self._get_prior_bounds_for_parameters(config["parameters"]))
        if "rng" in inspect.signature(rc.__init__).parameters:
            config.setdefault("rng", self.rng)
        logger.debug("Instantiating %s with config: %s", rc.__name__, config)
        return rc(**config)

    def configure_reparameterisations(self, reparameterisations) -> None:
        """Build the stack from the user's spec, as the JAX package does:

        - None: the fallback reparameterisation on every parameter;
        - a name: that reparameterisation on every parameter;
        - a dict of parameter -> name | dict(reparameterisation=...,
          **kwargs) | list of chained specs, or of reparameterisation
          name / label -> {parameters: [...], **kwargs}. Parameter keys
          and values may be regex patterns.

        Then :meth:`add_default_reparameterisations` (with
        :attr:`use_default_reparameterisations`), then the fallback
        (``fallback_reparameterisation``, or the identity for None) on
        the parameters no spec covers.
        """
        self._reparameterisation = CombinedReparameterisation(reverse_order=self.reverse_reparameterisations)
        names = list(self.model.names)
        specs = parse_reparameterisations(
            reparameterisations, model_names=names, class_name=type(self).__name__
        )
        assigned = set()
        for spec in specs:
            r = self.instantiate_reparameterisation_from_spec(spec)
            self._reparameterisation.add_reparameterisation(r)
            assigned.update(r.parameters)

        if self.use_default_reparameterisations:
            before = set(self._reparameterisation.parameters)
            self.add_default_reparameterisations()
            assigned.update(set(self._reparameterisation.parameters) - before)

        remaining = [n for n in names if n not in assigned]
        if remaining and self.fallback_reparameterisation is not None:
            cls, kwargs = get_reparameterisation(self.fallback_reparameterisation)
            kwargs.setdefault("prior_bounds", self._get_prior_bounds_for_parameters(remaining))
            self._reparameterisation.add_reparameterisation(cls(parameters=remaining, rng=self.rng, **kwargs))
        elif remaining:
            self._reparameterisation.add_reparameterisation(NullReparameterisation(parameters=remaining))
        self.use_x_prime_prior = self._reparameterisation.has_prime_prior

    def set_rescaling(self) -> None:
        """Set the x-space parameters (the model's names, then the
        stack's auxiliary parameters) and the x'-space parameters."""
        if self._reparameterisation is None:
            self.configure_reparameterisations(self.reparameterisations)
        self.parameters = list(self.model.names) + [
            a for a in self._reparameterisation.auxiliary_parameters if a not in self.model.names
        ]
        self.prime_parameters = list(self._reparameterisation.prime_parameters)
        logger.info("x-space parameters: %s", self.parameters)
        logger.info("x'-space parameters: %s", self.prime_parameters)

    def verify_rescaling(self) -> None:
        """Check that the reparameterisations round-trip on prior draws,
        without and with ``compute_radius`` (duplicating inversions
        return the input tiled)."""
        if not self._reparameterisation.one_to_one:
            logger.warning("Could not check if reparameterisation is invertible")
            return
        x = self.model.new_point(N=100)
        if self.map_to_unit_hypercube:
            x = self.model.to_unit_hypercube(x)
        x = self._convert_to_x(x)
        for compute_radius in (False, True):
            self._reparameterisation.update(x)
            x_prime, log_j = self.rescale(x, compute_radius=compute_radius)
            x_out, log_j_inv = self.inverse_rescale(x_prime, return_unit_hypercube=True)
            k = len(x_out) // len(x)
            if k * len(x) != len(x_out):
                raise RuntimeError("Rescaling changed the number of samples by a non-integer factor")
            x_tiled = np.tile(x, k)
            for n in self.model.names:
                if not np.allclose(x_tiled[n], x_out[n], atol=1e-8, equal_nan=True):
                    raise RuntimeError(f"Rescaling is not invertible for {n}")
            if not np.allclose(log_j, -log_j_inv, atol=1e-8):
                raise RuntimeError("Rescaling Jacobian is not invertible")
        self._reparameterisation.reset()

    def _convert_to_x(self, points):
        """Widen model-space points to the proposal's x dtype (adds the
        auxiliary fields)."""
        if points.dtype == self.x_dtype:
            return points
        out = empty_structured_array(len(points), dtype=self.x_dtype)
        for n in points.dtype.names:
            if n in out.dtype.names:
                out[n] = points[n]
        return out

    def rescale(self, x, compute_radius: bool = False):
        """x -> (x', log|dx'/dx|)."""
        x_prime = np.zeros(len(x), dtype=self.x_prime_dtype)
        log_j = np.zeros(len(x))
        _, x_prime, log_j = self._reparameterisation.reparameterise(
            x.copy(), x_prime, log_j, compute_radius=compute_radius
        )
        return x_prime, log_j

    def inverse_rescale(self, x_prime, return_unit_hypercube: bool = False, **kwargs):
        """x' -> (x, log|dx/dx'|). With ``map_to_unit_hypercube`` the
        stack's x is the unit hypercube, mapped to the model's space
        unless ``return_unit_hypercube``."""
        x = empty_structured_array(len(x_prime), dtype=self.x_dtype)
        log_j = np.zeros(len(x_prime))
        x, x_prime, log_j = self._reparameterisation.inverse_reparameterise(x, x_prime, log_j, **kwargs)
        for p in global_config.livepoints.non_sampling_parameters:
            if p in x_prime.dtype.names and p in x.dtype.names:
                x[p] = x_prime[p]
        if self.map_to_unit_hypercube and not return_unit_hypercube:
            x = self.model.from_unit_hypercube(x)
        return x, log_j

    def check_state(self, x) -> None:
        """Fit the reparameterisations to the live points ``x``."""
        if self.map_to_unit_hypercube:
            x = self.model.to_unit_hypercube(x)
        self._reparameterisation.update(x)

    # ------------------------------------------------------------------
    def train(self, x, plot: bool = True) -> None:
        """Fit the reparameterisations to ``x`` and train the flow on
        their output (with its loss plot where ``plot`` and the
        proposal's plotting allow)."""
        if not self.initialised:
            raise RuntimeError("Proposal must be initialised before training")
        x = np.asarray(x).copy()
        if self.map_to_unit_hypercube:
            x = self.model.to_unit_hypercube(x)
        x = self._convert_to_x(x)
        self.training_data = x.copy()
        if self.save_training_data:
            np.save(os.path.join(self.output, f"training_data_{self.training_count}.npy"), x)
        self._reparameterisation.update(x)
        x_prime, _ = self.rescale(x)
        x_prime = live_points_to_array(x_prime, self.prime_parameters)
        history, conditional = self._train_flow(x_prime)
        self.training_latent = self.training_log_q = None
        if self.requires_training_latent:
            self.training_latent, self.training_log_q = self.flow.forward_and_log_prob(x_prime, conditional)
        if self._plot_training and plot and history["loss"]:
            try:
                from ...plot import plot_loss

                plot_loss(
                    int(np.argmin(history["val_loss"])),
                    history,
                    filename=os.path.join(self.flow.output, "loss.png"),
                )
            except Exception as e:
                logger.warning("Could not plot loss: %s", e)
        self.training_count += 1
        self.populated = False

    #: whether :meth:`train` keeps the training data's forward images
    #: (a subclass whose truncation reads them says so)
    requires_training_latent = False

    def _train_flow(self, x_prime):
        """Train the flow on its columns ``x_prime``; returns the history
        and the training points' conditional (None: the flow takes no
        context)."""
        return self.flow.train(x_prime, save=self.save_flow_weights), None

    # ------------------------------------------------------------------
    # Flow passes (``nessai_tpu/proposal/flowproposal/base.py:785-835``)
    # ------------------------------------------------------------------
    def forward_pass(self, x, rescale: bool = True, compute_radius: bool = False):
        """x -> (z, log q(x)): through the reparameterisations (with
        ``rescale``; else ``x`` holds the flow's columns) and the flow."""
        log_j = 0.0
        if rescale:
            x_prime, log_j = self.rescale(x, compute_radius=compute_radius)
            x_array = live_points_to_array(x_prime, self.prime_parameters)
        else:
            x_array = live_points_to_array(x, self.parameters)
        z, log_q = self.flow.forward_and_log_prob(x_array)
        return z, log_q + log_j

    def backward_pass(
        self,
        z,
        rescale: bool = True,
        discard_nans: bool = True,
        return_z: bool = False,
        return_unit_hypercube: Optional[bool] = None,
    ):
        """z -> (x, log q(x)): the flow's inverse (at the latent
        temperature, where the proposal has one) and the inverse
        reparameterisations, keeping the points inside the prior bounds
        (and, with ``discard_nans``, of finite log q). ``rescale`` is
        taken as in the JAX package and the reparameterisations are
        always inverted. With ``map_to_unit_hypercube`` the points stay
        in the unit hypercube unless ``return_unit_hypercube`` is False.
        ``return_z`` also returns the kept latent points."""
        x_prime_array, log_q = self.flow.inverse_and_log_prob(
            z, temperature=getattr(self, "latent_temperature", None)
        )
        x_prime = np.zeros(len(x_prime_array), dtype=self.x_prime_dtype)
        for i, p in enumerate(self.prime_parameters):
            x_prime[p] = x_prime_array[:, i]
        x, log_j_inv = self.inverse_rescale(x_prime, return_unit_hypercube=True)
        return self._keep_in_bounds(x, log_q - log_j_inv, z, discard_nans, return_z, return_unit_hypercube)

    def _keep_in_bounds(self, x, log_q, z, discard_nans=True, return_z=False, return_unit_hypercube=None):
        """The tail of :meth:`backward_pass`: the points inside the prior
        bounds (the unit hypercube with ``map_to_unit_hypercube``) and,
        with ``discard_nans``, of finite ``log_q``."""
        keep = self.model.in_unit_hypercube(x) if self.map_to_unit_hypercube else self.model.in_bounds(x)
        if discard_nans:
            keep = keep & np.isfinite(log_q)
        x, log_q, z = x[keep], log_q[keep], np.asarray(z)[keep]
        if return_unit_hypercube is False and self.map_to_unit_hypercube:
            x = self.model.from_unit_hypercube(x)
        if return_z:
            return x, log_q, z
        return x, log_q

    def plot_pool(self, x) -> None:
        """Plot the pool's 1-D distributions to ``pool_<n>.png`` (logged
        and skipped where it fails)."""
        try:
            from ...plot import plot_1d_comparison

            plot_1d_comparison(
                x,
                labels=["pool"],
                filename=os.path.join(self.output, f"pool_{self.populated_count}.png"),
            )
        except Exception as e:
            logger.warning("Could not plot pool: %s", e)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def __getstate__(self):
        """The flow, the pool and the populated flag stay out of the
        pickle, as in the JAX package; the fitted reparameterisations go
        in. The flow is rebuilt from its last weight file at
        :meth:`resume`."""
        state = super().__getstate__()
        state["training_latent"] = None
        state["training_log_q"] = None
        state["x"] = None
        state["samples"] = []
        state["indices"] = []
        state["populated"] = False
        flow = state.pop("flow")
        state["_weights_file"] = flow.weights_file if flow is not None else None
        state["flow"] = None
        state["_initialised"] = False
        # as the JAX proposal does: a resumed run is on one device
        state["mesh"] = None
        return state

    def resume(self, model, flow_config=None, training_config=None, weights_file=None) -> None:
        """Rebind the model, rebuild the flow on :attr:`device` and load
        ``weights_file`` (by default the last weights saved before the
        checkpoint). The pool is empty: the run populates afresh."""
        super().resume(model)
        if flow_config is not None:
            self.flow_config = dict(flow_config)
        if training_config is not None:
            self.training_config = training_config
        self.initialise(resumed=True)
        if weights_file is None:
            weights_file = getattr(self, "_weights_file", None)
        if weights_file is not None and os.path.exists(weights_file):
            self.flow.load_weights(weights_file)
        self.populated = False

    # ------------------------------------------------------------------
    def log_prior(self, x):
        """x-space log-prior (on the unit hypercube with
        ``map_to_unit_hypercube``), with the auxiliary parameters'
        priors."""
        log_p = self.model.batch_evaluate_log_prior(x, unit_hypercube=self.map_to_unit_hypercube)
        return log_p + self._reparameterisation.log_prior(x)

    def unit_hypercube_log_prior(self, x):
        """The log-prior of ``x`` given in the unit hypercube, with the
        auxiliary parameters' priors."""
        return self.model.batch_evaluate_log_prior(x, unit_hypercube=True) + self._reparameterisation.log_prior(x)

    def x_prime_log_prior(self, x_prime):
        return self._reparameterisation.x_prime_log_prior(x_prime)

    def compute_weights(self, x, log_q):
        """logW = logP - logQ."""
        log_p = self.log_prior(x)
        x["logP"] = log_p
        return log_p - log_q

    def convert_to_samples(self, x):
        """Model-space samples with the log-prior set."""
        if self.map_to_unit_hypercube:
            x = self.model.from_unit_hypercube(x)
        out = empty_structured_array(len(x), names=self.model.names)
        for n in self.model.names:
            out[n] = x[n]
        for f in global_config.livepoints.non_sampling_parameters:
            out[f] = x[f]
        out["logP"] = self.model.batch_evaluate_log_prior(out)
        return out

    def populate(self, worst_point, n_samples=10000):
        raise NotImplementedError

    def compute_acceptance(self, logL) -> float:
        """The share of the pool above the likelihood ``logL``."""
        return float(np.mean(self.samples["logL"] > logL))

    def reset(self) -> None:
        """Drop the pool, the training data's images and the acceptance
        records."""
        self.samples = []
        self.indices = []
        self.populated = False
        self.x = None
        self.training_latent = None
        self.training_log_q = None
        self.acceptance = []
        self.populated_count = 0

    def draw(self, worst_point):
        """Pop a sample from the pool, repopulating (with the adaptive
        poolsize where ``update_poolsize``) when empty."""
        if not self.populated:
            if self.update_poolsize:
                self.update_poolsize_scale(self.ns_acceptance)
            while not self.populated:
                self.populate(worst_point, n_samples=self.poolsize)
        index = self.indices.pop()
        new_sample = self.samples[index]
        if not self.indices:
            self.populated = False
        return new_sample
