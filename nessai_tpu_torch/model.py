"""User model definition. Counterpart of ``nessai_tpu/model.py``.

A ``Model`` has ``names`` and ``bounds`` and implements ``log_prior`` and
``log_likelihood`` over structured arrays. The importance nested sampler
also needs the maps ``to_unit_hypercube`` and ``from_unit_hypercube``
(given by :class:`UniformPriorMixin` for a uniform prior box). The optional
``torch_log_likelihood(x)`` hook takes a ``[n, dims]`` float32 tensor on
the model's device (columns ordered like ``names``) and returns ``[n]``
log-likelihoods; when present, batched evaluation and the flow
proposal's populate run it on the device. A likelihood that needs data
(observed strain, PSDs) declares it as ``torch_likelihood_data``, a dict of
numpy arrays: the hook is then called as ``torch_log_likelihood(x, data)``
with the same dict as tensors on ``x``'s device, moved there once a device
and never pickled. A host likelihood joins the populate's device call with
``likelihood_callback = True``. The device populate loop needs
the prior on the device too: a ``torch_log_prior(x)`` hook of the same
form, or a uniform prior on the box of ``bounds`` (declared with
``uniform_prior_box = True``, or found by :attr:`Model.has_uniform_box_prior`).
"""

import datetime
import logging
from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np
import torch

from . import config
from .livepoint import (
    empty_structured_array,
    live_points_to_array,
    numpy_array_to_live_points,
    unstructured_view as _unstructured_view,
)
from .utils.device import get_device
from .utils.errors import RNGNotSetError, RNGSetError
from .utils.multiprocessing import (
    batch_evaluate_function,
    check_vectorised_function,
    get_n_pool,
    forking_pool,
    initialise_pool_variables,
    log_likelihood_wrapper,
    log_prior_wrapper,
)
from .utils.profiling import annotate, counts

logger = logging.getLogger(__name__)

__all__ = ["Model", "ModelError", "OneDimensionalModelError", "UniformPriorMixin"]


class ModelError(RuntimeError):
    """Raised for invalid models."""


class OneDimensionalModelError(ModelError):
    """Raised for 1-D models, which nessai does not support."""


def _traced_likelihood(ll):
    """``ll(x, data)`` counted in ``likelihood_rows`` and traced as the
    device span ``likelihood``."""

    def fn(x, data):
        rows = int(x.shape[0])
        counts.likelihood_rows += rows
        with annotate("likelihood", device=x.is_cuda, rows=rows):
            return ll(x, data)

    return fn


class Model(ABC):
    """Base class for user-defined problems."""

    _names: Optional[List[str]] = None
    _bounds: Optional[dict] = None
    _lower = None
    _upper = None
    _dims = None
    _vectorised_likelihood = None
    _vectorised_prior = None
    _vectorised_prior_unit_hypercube = None

    likelihood_evaluations: int = 0
    likelihood_evaluation_time = datetime.timedelta()
    allow_vectorised: bool = True
    #: Allow the prior (and the unit-hypercube prior) to be evaluated on
    #: batches; False makes both per point
    allow_vectorised_prior: bool = True
    allow_multi_valued_likelihood: bool = False
    #: names of the discrete parameters (None if there are none): the
    #: model check then draws its probe with ``new_point``
    discrete_parameters: Optional[List[str]] = None
    rng: Optional[np.random.Generator] = None
    #: Device of ``torch_log_likelihood`` (``None`` means CUDA); the
    #: sampler sets it to its own device.
    device = None
    #: Optional device hook: ``[n, dims]`` float32 tensor -> ``[n]``;
    #: ``(x, data)`` where :attr:`torch_likelihood_data` is set.
    torch_log_likelihood = None
    #: Optional data of ``torch_log_likelihood``: a dict of numpy arrays
    #: (observed data, PSDs, ...), given to the hook as float32 tensors on
    #: the device it runs on (:meth:`device_log_likelihood_fn`)
    torch_likelihood_data = None
    #: Let the host ``log_likelihood`` stand in for a device likelihood
    #: where no ``torch_log_likelihood`` is defined: the populate's device
    #: call may then evaluate it on its rows (copied to the host and back)
    likelihood_callback: bool = False
    #: Optional device prior, of the same form as ``torch_log_likelihood``.
    torch_log_prior = None
    #: Whether ``log_prior`` is the uniform density on the box of
    #: ``bounds`` (:class:`UniformPriorMixin` sets it)
    uniform_prior_box: bool = False
    #: Host likelihoods in chunks of at most this many points (None: one
    #: batch)
    likelihood_chunksize: Optional[int] = None
    #: Evaluate the prior through the pool as well
    parallelise_prior: bool = False
    #: Pool of worker processes for host likelihoods (see
    #: :meth:`configure_pool`); never pickled
    pool = None
    n_pool: Optional[int] = None
    _pool_configured: bool = False

    @property
    def names(self) -> List[str]:
        return self._names if self._names is not None else []

    @names.setter
    def names(self, names):
        if not isinstance(names, list):
            raise TypeError("`names` must be a list")
        if not names:
            raise ValueError("`names` list is empty!")
        if len(names) == 1:
            raise OneDimensionalModelError(
                "names list has length 1. nessai is not designed to handle "
                "one-dimensional models."
            )
        self._names = names
        self._dims = None

    @property
    def bounds(self) -> dict:
        return self._bounds if self._bounds is not None else {}

    @bounds.setter
    def bounds(self, bounds):
        if not isinstance(bounds, dict):
            raise TypeError("`bounds` must be a dictionary")
        if len(bounds) == 1:
            raise OneDimensionalModelError(
                "bounds dictionary has length 1. nessai is not designed "
                "to handle one-dimensional models."
            )
        if not all(len(b) == 2 for b in bounds.values()):
            raise ValueError("Each entry in `bounds` must have length 2")
        self._bounds = {p: np.asarray(b) for p, b in bounds.items()}
        self._lower = None
        self._upper = None

    @property
    def dims(self) -> int:
        if self._dims is None and self.names:
            self._dims = len(self.names)
        return self._dims

    @property
    def lower_bounds(self) -> np.ndarray:
        if self._lower is None and self.bounds:
            self._lower = np.array(
                [self.bounds[n][0] for n in self.names], dtype=float
            )
        return self._lower

    @property
    def upper_bounds(self) -> np.ndarray:
        if self._upper is None and self.bounds:
            self._upper = np.array(
                [self.bounds[n][1] for n in self.names], dtype=float
            )
        return self._upper

    def set_rng(self, rng: Optional[np.random.Generator] = None) -> None:
        """Set the model's random number generator (once)."""
        if rng is None:
            rng = np.random.default_rng()
        if self.rng is not None:
            raise RNGSetError()
        self.rng = rng

    def _require_rng(self) -> np.random.Generator:
        if self.rng is None:
            raise RNGNotSetError()
        return self.rng

    @abstractmethod
    def log_prior(self, x) -> np.ndarray:
        """Log-prior of structured live points."""
        raise NotImplementedError

    @abstractmethod
    def log_likelihood(self, x) -> np.ndarray:
        """Log-likelihood of structured live points."""
        raise NotImplementedError

    @property
    def has_discrete_parameters(self) -> bool:
        return self.discrete_parameters is not None

    @property
    def has_torch_likelihood(self) -> bool:
        return callable(self.torch_log_likelihood)

    @property
    def has_torch_prior(self) -> bool:
        return callable(self.torch_log_prior)

    def _callback_log_likelihood(self, arr) -> np.ndarray:
        """The host ``log_likelihood`` of a ``[n, dims]`` array in
        ``names`` order, as float32; counts nothing (the caller does)."""
        x = numpy_array_to_live_points(np.asarray(arr, np.float64), self.names)
        out = batch_evaluate_function(
            self.log_likelihood, x, self.vectorised_likelihood, chunksize=self.likelihood_chunksize
        )
        return np.asarray(out, np.float32)

    def device_log_likelihood_fn(self, device=None):
        """``(fn, data)`` where ``fn(x, data)`` evaluates the likelihood of
        a ``[n, dims]`` float32 tensor on ``device`` (by default the
        model's), or None where there is no device path. ``data`` is
        :attr:`torch_likelihood_data` as tensors on ``device`` (None when
        unused). The ``torch_log_likelihood`` hook comes first, traced as
        the span ``likelihood`` (its rows and device time) with its rows
        counted; else, with :attr:`likelihood_callback`, the host
        ``log_likelihood`` on the rows, returned as float32 on the rows'
        device."""
        if self.has_torch_likelihood:
            ll = self.torch_log_likelihood
            if self.torch_likelihood_data is not None:
                device = get_device(self.device if device is None else device)
                return _traced_likelihood(ll), self._device_likelihood_data(device)
            return _traced_likelihood(lambda x, data: ll(x)), None
        if not self.likelihood_callback:
            return None

        def callback_ll(x, data):
            out = self._callback_log_likelihood(x.detach().cpu().numpy())
            return torch.as_tensor(out, device=x.device)

        return callback_ll, None

    def _device_likelihood_data(self, device) -> dict:
        """:attr:`torch_likelihood_data` as tensors on ``device``
        (floating arrays as float32), moved once a device and cached until
        the attribute is rebound to another object."""
        data = self.torch_likelihood_data
        if data is None:
            return None
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        cache = self.__dict__.get("_ll_data_device_cache")
        if cache is None or cache[0] is not data:
            cache = (data, {})
            self._ll_data_device_cache = cache
        if device not in cache[1]:
            tensors = {}
            for k, v in data.items():
                v = np.asarray(v)
                floating = np.issubdtype(v.dtype, np.floating)
                tensors[k] = torch.as_tensor(v, dtype=torch.float32 if floating else None, device=device)
            cache[1][device] = tensors
        return cache[1][device]

    def get_device_log_likelihood(self, device=None):
        """``fn(x)`` with the data of :meth:`device_log_likelihood_fn`
        bound, or None."""
        built = self.device_log_likelihood_fn(device)
        if built is None:
            return None
        fn, data = built
        return lambda x: fn(x, data)

    @property
    def has_uniform_box_prior(self) -> bool:
        """Whether ``log_prior`` is the uniform density on the box of
        ``bounds``: declared (``uniform_prior_box``), or found by probing,
        as the JAX package does (``nessai_tpu/model.py:694-760``). The
        probe evaluates ``log_prior`` at 256 points drawn uniformly in the
        box from a generator of its own and accepts only if every value
        equals ``-sum(log(width))`` to 1e-9. Its answer is cached. A model
        with a ``torch_log_prior`` is not probed."""
        if self.uniform_prior_box:
            return True
        if self.has_torch_prior:
            return False
        cached = getattr(self, "_uniform_box_detected", None)
        if cached is not None:
            return cached
        detected = False
        try:
            lower = np.asarray(self.lower_bounds, float)
            upper = np.asarray(self.upper_bounds, float)
            if np.all(np.isfinite(lower)) and np.all(np.isfinite(upper)):
                pts = np.random.default_rng(818118).uniform(lower, upper, (256, self.dims))
                x = numpy_array_to_live_points(pts, self.names)
                log_p = np.asarray(
                    batch_evaluate_function(
                        self.log_prior, x, self.vectorised_prior, func_wrapper=log_prior_wrapper
                    ),
                    float,
                )
                const = -np.sum(np.log(upper - lower))
                detected = bool(np.all(np.isfinite(log_p)) and np.allclose(log_p, const, rtol=0, atol=1e-9))
                if detected:
                    logger.info(
                        "Detected a uniform box prior (constant %.6f over the bounds): the prior is "
                        "evaluated on the device",
                        const,
                    )
        except Exception as e:
            logger.debug("Uniform-box prior probe failed: %s", e)
        self._uniform_box_detected = detected
        return detected

    def in_bounds(self, x) -> np.ndarray:
        """Elementwise check that points lie in the prior box."""
        return ~np.any(
            [
                (x[n] < self.bounds[n][0]) | (x[n] > self.bounds[n][1])
                for n in self.names
            ],
            axis=0,
        )

    def in_unit_hypercube(self, x) -> np.ndarray:
        """Elementwise check that points lie in the unit hypercube."""
        return ~np.any(
            [(x[n] < 0.0) | (x[n] > 1.0) for n in self.names], axis=0
        )

    def to_unit_hypercube(self, x):
        """Map live points to the unit hypercube (required by the
        importance nested sampler)."""
        raise NotImplementedError

    def from_unit_hypercube(self, x):
        """Inverse of :meth:`to_unit_hypercube`."""
        raise NotImplementedError

    def unstructured_view(self, x) -> np.ndarray:
        return _unstructured_view(x, names=self.names)

    def parameter_in_bounds(self, x, name) -> np.ndarray:
        """Elementwise check that values of parameter ``name`` lie in its
        bounds."""
        return (x >= self.bounds[name][0]) & (x <= self.bounds[name][1])

    def sample_parameter(self, name, n=1):
        """Draw ``n`` values of one parameter from its prior; not
        implemented by default."""
        raise NotImplementedError("User must implement this method!")

    @classmethod
    def check_new_point_methods(cls):
        """``new_point`` and ``new_point_log_prob`` must be redefined
        together; raises :class:`ModelError` where one is alone."""
        if cls.new_point != Model.new_point:
            logger.debug("`new_point` method has been redefined.")
            if cls.new_point_log_prob == Model.new_point_log_prob:
                raise ModelError("`new_point` method has been redefined but `new_point_log_prob` has not.")
        if cls.new_point_log_prob != Model.new_point_log_prob:
            logger.debug("`new_point_log_prob` method has been redefined.")
            if cls.new_point == Model.new_point:
                raise ModelError("`new_point_log_prob` method has been redefined but `new_point` has not.")

    def batch_evaluate_dtype(self):
        """The float dtype of the live points' fields."""
        return config.livepoints.default_float_dtype

    def new_point(self, N: int = 1):
        """Draw N points from the prior box with finite log-prior, by
        rejection."""
        rng = self._require_rng()
        out = empty_structured_array(N, names=self.names)
        count = 0
        while count < N:
            arr = rng.uniform(
                self.lower_bounds, self.upper_bounds, (N - count, self.dims)
            )
            points = numpy_array_to_live_points(arr, self.names)
            finite = np.isfinite(self.batch_evaluate_log_prior(points))
            n_ok = int(finite.sum())
            if n_ok:
                out[count : count + n_ok] = points[finite]
                count += n_ok
        if N == 1:
            return out[0:1]
        return out

    def new_point_log_prob(self, x) -> np.ndarray:
        """Proposal log-density of :meth:`new_point` (constant: zeros)."""
        return np.zeros(x.size)

    @property
    def vectorised_likelihood(self) -> bool:
        """Whether ``log_likelihood`` accepts batches: found by comparing
        batched and per-point outputs, unless set."""
        if self._vectorised_likelihood is None:
            if self.has_torch_likelihood:
                self._vectorised_likelihood = True
            elif not self.allow_vectorised:
                self._vectorised_likelihood = False
            else:
                self._vectorised_likelihood = check_vectorised_function(
                    self.log_likelihood, self.new_point(4)
                )
        return self._vectorised_likelihood

    @vectorised_likelihood.setter
    def vectorised_likelihood(self, value):
        self._vectorised_likelihood = value

    @property
    def vectorised_prior(self) -> bool:
        """Whether ``log_prior`` accepts batches (False where
        :attr:`allow_vectorised_prior` is False or the probe fails)."""
        if self._vectorised_prior is None:
            if not self.allow_vectorised_prior:
                self._vectorised_prior = False
                return False
            try:
                arr = self._require_rng().uniform(self.lower_bounds, self.upper_bounds, (4, self.dims))
                self._vectorised_prior = check_vectorised_function(
                    self.log_prior, numpy_array_to_live_points(arr, self.names)
                )
            except Exception:
                self._vectorised_prior = False
        return self._vectorised_prior

    @vectorised_prior.setter
    def vectorised_prior(self, value):
        self._vectorised_prior = value

    @property
    def vectorised_prior_unit_hypercube(self) -> bool:
        """Whether ``log_prior_unit_hypercube`` accepts batches, as
        :attr:`vectorised_prior`."""
        if self._vectorised_prior_unit_hypercube is None:
            if not self.allow_vectorised_prior:
                self._vectorised_prior_unit_hypercube = False
                return False
            try:
                self._vectorised_prior_unit_hypercube = check_vectorised_function(
                    self.log_prior_unit_hypercube, self.sample_unit_hypercube(4)
                )
            except Exception:
                self._vectorised_prior_unit_hypercube = False
        return self._vectorised_prior_unit_hypercube

    @vectorised_prior_unit_hypercube.setter
    def vectorised_prior_unit_hypercube(self, value):
        self._vectorised_prior_unit_hypercube = value

    def configure_pool(self, pool=None, n_pool=None) -> None:
        """Use ``pool`` (any object with ``map``), or a new
        ``multiprocessing.Pool`` of ``n_pool`` forked workers, for host
        likelihoods. A device likelihood (``torch_log_likelihood``) is
        never evaluated through the pool, so a worker never touches
        CUDA."""
        self.n_pool = n_pool
        if pool is not None:
            self.pool = pool
            n = get_n_pool(pool)
            if n is not None:
                self.n_pool = n
        elif n_pool is not None:
            # forked workers share the model through a module global,
            # as in the JAX package, and run only host code
            initialise_pool_variables(self)
            self.pool = forking_pool(self, n_pool)
        self._pool_configured = self.pool is not None

    def close_pool(self, code=None) -> None:
        """Close the pool (terminate it for ``code == 2``) and wait for
        its workers."""
        if self.pool is not None:
            logger.info("Closing pool")
            if code == 2:
                self.pool.terminate()
            else:
                self.pool.close()
            self.pool.join()
            self.pool = None
            self._pool_configured = False

    def evaluate_log_likelihood(self, x):
        """Single-point evaluation with counter update."""
        self.likelihood_evaluations += 1
        return self.log_likelihood(x)

    def batch_evaluate_log_likelihood(self, x, unit_hypercube: bool = False) -> np.ndarray:
        """Log-likelihoods of a batch of live points (given in the unit
        hypercube with ``unit_hypercube``), with the counter and
        wall-time updated. With a ``torch_log_likelihood`` hook the batch
        is evaluated on the model's device in float32 and returned as
        float64."""
        if unit_hypercube:
            x = self.from_unit_hypercube(x)
        st = datetime.datetime.now()
        if self.has_torch_likelihood:
            device = get_device(self.device)
            fn, data = self.device_log_likelihood_fn(device)
            arr = torch.as_tensor(live_points_to_array(x, self.names), dtype=torch.float32, device=device)
            with torch.no_grad():
                out = fn(arr, data)
            out = out.cpu().numpy().astype(np.float64)
            counts.host_reads += 1
        else:
            out = batch_evaluate_function(
                self.log_likelihood,
                x,
                self.vectorised_likelihood,
                chunksize=self.likelihood_chunksize,
                func_wrapper=log_likelihood_wrapper,
                n_pool=self.n_pool,
                pool=self.pool,
            )
        self.likelihood_evaluation_time += datetime.datetime.now() - st
        self.likelihood_evaluations += len(x)
        return out

    def batch_evaluate_log_prior(self, x, unit_hypercube: bool = False) -> np.ndarray:
        if unit_hypercube:
            x = self.from_unit_hypercube(x)
        return batch_evaluate_function(
            self.log_prior,
            x,
            self.vectorised_prior,
            func_wrapper=log_prior_wrapper,
            n_pool=self.n_pool if self.parallelise_prior else None,
            pool=self.pool if self.parallelise_prior else None,
        )

    def log_prior_unit_hypercube(self, x) -> np.ndarray:
        """Log-prior density in the unit hypercube: zero inside it (the
        inverse-CDF map of the prior), -inf outside. Override together
        with ``from_unit_hypercube`` where the map does not make the
        prior uniform."""
        out = np.zeros(len(np.atleast_1d(x)))
        out[~self.in_unit_hypercube(x)] = -np.inf
        return out

    def batch_evaluate_log_prior_unit_hypercube(self, x) -> np.ndarray:
        return batch_evaluate_function(
            self.log_prior_unit_hypercube, x, self.vectorised_prior_unit_hypercube
        )

    def sample_unit_hypercube(self, n: int = 1) -> np.ndarray:
        """Uniform draws in the unit hypercube as live points."""
        arr = self._require_rng().uniform(size=(n, self.dims))
        return numpy_array_to_live_points(arr, self.names)

    def verify_model(self) -> None:
        """Sanity-check the model definition."""
        if not self.names:
            raise ModelError("Names for model parameters are not set")
        if not self.bounds:
            raise ModelError("Bounds are not set for model")
        self.check_new_point_methods()
        for n in self.names:
            b = self.bounds.get(n)
            if b is None or len(b) != 2:
                raise ModelError(f"Bounds for {n} are invalid: {b}")
            if b[1] <= b[0]:
                raise ModelError(f"Bounds for {n} are not ordered: {b}")
        rng = self._require_rng()
        if not (
            np.isfinite(self.lower_bounds).all()
            and np.isfinite(self.upper_bounds).all()
        ):
            raise ModelError("The port supports finite prior bounds only")
        if self.has_discrete_parameters:
            # a box draw cannot hit a discrete support: probe with new_point
            logger.warning("Model has discrete parameters: testing with `new_point`")
            try:
                self.log_prior(self.new_point(1))
            except Exception as e:
                raise ModelError(
                    f"Could not draw a new point and compute the log prior with error: {e}"
                )
        else:
            log_p = -np.inf
            counter = 0
            while log_p == -np.inf or log_p == np.inf:
                arr = rng.uniform(self.lower_bounds, self.upper_bounds, (1, self.dims))
                probe = numpy_array_to_live_points(arr, self.names)
                try:
                    log_p = self.log_prior(probe)
                except Exception as e:
                    raise ModelError(f"Log-prior raised an error: {e}")
                if log_p is None:
                    raise ModelError("Log-prior returned None")
                log_p = float(np.asarray(log_p).flatten()[0])
                counter += 1
                if counter == 1000:
                    raise ModelError(
                        "Could not draw a valid point from within the prior "
                        "bounds after 1000 tries, check the log prior function."
                    )
        x = self.new_point()
        if self.log_prior(x) is None:
            raise ModelError("Log-prior returned None")
        log_l = self.evaluate_log_likelihood(x)
        if log_l is None:
            raise ModelError("Log-likelihood returned None")
        if np.isnan(float(np.asarray(log_l).flatten()[0])):
            raise ModelError("Log-likelihood is NaN at a prior draw")
        if not self.allow_multi_valued_likelihood:
            vals = np.array(
                [
                    np.asarray(self.log_likelihood(x)).flatten()[0]
                    for _ in range(16)
                ]
            )
            if not np.all(vals == vals[0]):
                raise ModelError(
                    "Repeated likelihood calls return different values; "
                    "set allow_multi_valued_likelihood=True to permit this."
                )

    def __getstate__(self):
        """The pool and the likelihood data's device tensors stay out of a
        pickle (the data's numpy arrays stay in; the tensors are made again
        on first use)."""
        state = self.__dict__.copy()
        state["pool"] = None
        state["_pool_configured"] = False
        state.pop("_ll_data_device_cache", None)
        return state


class UniformPriorMixin:
    """``log_prior`` and the unit-hypercube maps of a prior that is
    uniform inside ``bounds``. Use as ``class MyModel(UniformPriorMixin,
    Model)``."""

    uniform_prior_box: bool = True

    def log_prior(self, x):
        with np.errstate(divide="ignore"):
            log_p = np.log(self.in_bounds(x), dtype="float64")
        for n in self.names:
            log_p -= np.log(self.bounds[n][1] - self.bounds[n][0])
        return log_p

    def sample_parameter(self, name, n=1):
        """Uniform draws of one parameter in its bounds, from the model's
        ``rng``."""
        lo, hi = self.bounds[name]
        return self._require_rng().uniform(lo, hi, int(n))

    def to_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = (x[n] - lo) / (hi - lo)
        return x_out

    def from_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = x[n] * (hi - lo) + lo
        return x_out
