"""Reparameterisation base class. Counterpart of
``nessai_tpu/reparameterisations/base.py``.

Reparameterisations are host-side bijections x <-> x' applied to
structured live points before the (device-side) flow; signature
``reparameterise(x, x_prime, log_j) -> (x, x_prime, log_j)``. The
device inverse used by the flow proposal's populate is
:meth:`Reparameterisation.torch_inverse`.
"""

import logging
from typing import List

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["Reparameterisation"]


class Reparameterisation:
    """Base reparameterisation.

    Parameters
    ----------
    input_parameters : str or list
        Names of the parameters required in the forward direction.
    output_parameters : str or list, optional
        Names of the parameters produced in the prime space. Defaults to
        the input parameters with ``_prime`` appended.
    persistent_parameters : str or list, optional
        Subset of ``input_parameters`` that should remain exposed in the
        flow-facing parameter set after this reparameterisation.
    auxiliary_parameters : str or list, optional
        Extra x-space fields this reparameterisation creates (e.g. a
        sampled auxiliary radius); added to the x dtype by the proposal.
    prior_bounds : list, dict or None
        Prior bounds for the parameter(s).
    rng : numpy Generator, optional
    inverse_input_parameters : str or list, optional
        Parameters required for the inverse reparameterisation.
    parameters : str or list, optional
        Alias for ``input_parameters``.
    """

    #: One x parameter maps to exactly one x' parameter.
    one_to_one = True
    #: Parameters (in either space) that must exist before this
    #: reparameterisation's inverse can run.
    requires: List[str] = []
    #: Whether this reparameterisation requires prior bounds
    requires_prior_bounds = False
    #: Set if the reparameterisation defines a prior on x' space
    has_prime_prior = False
    #: Set if the reparameterisation contributes a log-prior term
    has_prior = False
    #: Set if update_bounds/update is required before use
    requires_bounded_prior = False
    _update = False
    prior_bounds = None

    def __init__(
        self,
        input_parameters=None,
        output_parameters=None,
        persistent_parameters=None,
        auxiliary_parameters=None,
        prior_bounds=None,
        rng=None,
        inverse_input_parameters=None,
        parameters=None,
    ):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.input_parameters = self._reconcile_parameter_kwargs(
            parameters, input_parameters
        )
        self.prior_bounds = self._normalise_prior_bounds(prior_bounds)

        self.output_parameters = self._format_parameters(
            output_parameters
        ) or [f"{p}_prime" for p in self.input_parameters]
        self.persistent_parameters = self._format_parameters(
            persistent_parameters
        )
        stray = set(self.persistent_parameters) - set(self.input_parameters)
        if stray:
            raise RuntimeError(
                "Persistent parameters must be a subset of the input "
                f"parameters. Received {self.persistent_parameters} for "
                f"{self.input_parameters}."
            )
        self.auxiliary_parameters = self._format_parameters(
            auxiliary_parameters
        )
        self.inverse_input_parameters = self._format_parameters(
            inverse_input_parameters
        )
        # Namespace assignments filled in by the resolve_* methods once
        # the combined reparameterisation knows which names each stage
        # of the chain produces; None = not yet resolved.
        self._fwd_split = None
        self._inv_split = None

    @staticmethod
    def _format_parameters(parameters):
        """Normalise a name spec (None | str | list of str) to a fresh
        list."""
        if parameters is None:
            return []
        if isinstance(parameters, str):
            return [parameters]
        if isinstance(parameters, list):
            return list(parameters)
        raise TypeError(
            "Parameters must be a string or a list of strings."
        )

    def _reconcile_parameter_kwargs(self, parameters, input_parameters):
        """Merge the legacy ``parameters`` kwarg with
        ``input_parameters`` and validate the result."""
        if None not in (parameters, input_parameters):
            if self._format_parameters(parameters) != self._format_parameters(
                input_parameters
            ):
                raise RuntimeError(
                    "Received conflicting values for `parameters` and "
                    "`input_parameters`."
                )
        names = input_parameters if input_parameters is not None else parameters
        if names is None:
            raise RuntimeError("Must specify parameters")
        if not isinstance(names, (str, list)):
            raise TypeError("Parameters must be a str or list.")
        names = self._format_parameters(names)
        if any(not isinstance(p, str) for p in names):
            raise TypeError("Parameters must be a str or list of str")
        return names

    def _normalise_prior_bounds(self, prior_bounds):
        """Coerce ``prior_bounds`` to a ``{name: float array}`` dict
        (or None) and enforce this class's bounded/finite-prior
        requirements. ``self.input_parameters`` must already be set."""
        if prior_bounds is None:
            if self.requires_bounded_prior:
                raise RuntimeError(
                    f"Reparameterisation {self.name} requires prior bounds!"
                )
            logger.debug("No prior bounds for %s", self.name)
            return None
        if isinstance(prior_bounds, (list, tuple, np.ndarray)):
            # A bare pair applies to the (single) first parameter.
            if len(prior_bounds) != 2:
                raise RuntimeError("Prior bounds got a list of len > 2")
            prior_bounds = {self.input_parameters[0]: prior_bounds}
        if not isinstance(prior_bounds, dict):
            raise TypeError(
                "Prior bounds must be a dict, tuple, list or numpy array"
                " of len 2 or None."
            )
        unbounded = set(self.input_parameters) - set(prior_bounds)
        if unbounded:
            if self.requires_bounded_prior:
                raise RuntimeError(
                    "Mismatch between parameters and prior bounds: "
                    f"{set(self.input_parameters)}, "
                    f"{set(prior_bounds.keys())}"
                )
            logger.debug(
                "Missing prior bounds for parameters %s in %s",
                sorted(unbounded),
                self.name,
            )
        bounds = {
            p: np.asarray(b, dtype=float) for p, b in prior_bounds.items()
        }
        if self.requires_bounded_prior and not all(
            np.isfinite(b).all() for b in bounds.values()
        ):
            raise RuntimeError(
                f"Reparameterisation {self.name} requires finite prior "
                f"bounds. Received: {bounds}"
            )
        return bounds

    # ------------------------------------------------------------------
    # Parameter-namespace plumbing.
    #
    # A chained reparameterisation may consume names that an earlier
    # stage already moved into the prime space, so each stage records,
    # per direction, which of its declared inputs live in x and which
    # in x' (a per-direction space map).
    # ------------------------------------------------------------------
    @staticmethod
    def _partition_by_space(wanted, x_names, prime_names):
        """Assign each requested name to the namespace that defines it
        (x takes precedence over x'). Returns the ``{"x": [...],
        "prime": [...]}`` map plus the names found in neither space."""
        x_names = frozenset(x_names)
        prime_names = frozenset(prime_names)
        split = {"x": [], "prime": []}
        unknown = []
        for name in wanted:
            if name in x_names:
                split["x"].append(name)
            elif name in prime_names:
                split["prime"].append(name)
            else:
                unknown.append(name)
        return split, unknown

    def resolve_forward_input_spaces(
        self, available_parameters, available_prime_parameters
    ):
        """Record which namespace each forward input lives in; returns
        the inputs found in neither."""
        self._fwd_split, unknown = self._partition_by_space(
            self.input_parameters,
            available_parameters,
            available_prime_parameters,
        )
        return unknown

    def resolve_inverse_input_spaces(
        self, available_parameters, available_prime_parameters
    ):
        """Record which namespace each inverse input lives in; returns
        the inverse inputs found in neither."""
        self._inv_split, unknown = self._partition_by_space(
            self.inverse_input_parameters,
            available_parameters,
            available_prime_parameters,
        )
        return unknown

    @property
    def input_parameters(self):
        return self._input_parameters

    @input_parameters.setter
    def input_parameters(self, value):
        self._input_parameters = self._format_parameters(value)
        # a new input set invalidates any previous namespace assignment
        self._fwd_split = None
        self._inv_split = None

    @property
    def parameters(self):
        """Compatibility alias for ``input_parameters``."""
        return self.input_parameters

    @parameters.setter
    def parameters(self, value):
        self.input_parameters = value

    @property
    def prime_parameters(self):
        """Compatibility alias for ``output_parameters``."""
        return self.output_parameters

    @prime_parameters.setter
    def prime_parameters(self, value):
        self.output_parameters = self._format_parameters(value)

    @property
    def x_input_parameters(self):
        """Forward inputs living in the sampling (x) space; until
        resolution runs, every input is assumed to."""
        if self._fwd_split is None:
            return list(self.input_parameters)
        return list(self._fwd_split["x"])

    @property
    def x_prime_input_parameters(self):
        """Forward inputs an earlier stage already moved into x'."""
        if self._fwd_split is None:
            return []
        return list(self._fwd_split["prime"])

    @property
    def prime_input_parameters(self):
        """Compatibility alias for ``x_prime_input_parameters``."""
        return self.x_prime_input_parameters

    @property
    def x_output_parameters(self):
        """x-space names available downstream of this stage: its
        x-space inputs plus any auxiliary fields it creates (first
        occurrence wins)."""
        out = []
        for name in self.x_input_parameters + self.auxiliary_parameters:
            if name not in out:
                out.append(name)
        return out

    def _persistent_in(self, space):
        if self._fwd_split is None:
            return []
        keep = self._fwd_split[space]
        return [p for p in self.persistent_parameters if p in keep]

    @property
    def x_persistent_parameters(self):
        """Persistent inputs that resolved to the x space."""
        return self._persistent_in("x")

    @property
    def x_prime_persistent_parameters(self):
        """Persistent inputs that resolved to the x' space."""
        return self._persistent_in("prime")

    @property
    def x_inverse_input_parameters(self):
        """Inverse inputs that resolved to the x space."""
        if self._inv_split is None:
            return []
        return list(self._inv_split["x"])

    @property
    def x_prime_inverse_input_parameters(self):
        """Inverse inputs that resolved to the x' space."""
        if self._inv_split is None:
            return []
        return list(self._inv_split["prime"])

    def _pick_array(self, parameter, x, x_prime):
        """The structured array that currently holds ``parameter``:
        x' for inputs resolved to the prime space, and — for anything
        unresolved — whichever array's dtype carries the field (x
        preferred, so auxiliary parameters resolve in either)."""
        if parameter in self.x_prime_input_parameters:
            if x_prime is None:
                raise RuntimeError(
                    f"Prime-space input `{parameter}` requested for "
                    f"{self.name} but no x_prime array was provided."
                )
            return x_prime
        if x_prime is None:
            return x
        if x.dtype.names is not None and parameter in x.dtype.names:
            return x
        return x_prime

    def get_parameter_value(self, parameter, x, x_prime=None):
        """Read ``parameter`` from whichever space defines it."""
        return np.asarray(
            self._pick_array(parameter, x, x_prime)[parameter],
            dtype=float,
        )

    def set_parameter_value(self, parameter, value, x, x_prime=None):
        """Write ``parameter`` into whichever space defines it; returns
        the (x, x_prime) pair."""
        self._pick_array(parameter, x, x_prime)[parameter] = value
        return x, x_prime

    def __setstate__(self, state):
        """Migrate pickles from the parallel-list representation used
        before 0.6."""
        if "_fwd_split" not in state and "_x_input_parameters" in state:
            if state.pop("_resolved_forward_inputs", False):
                state["_fwd_split"] = {
                    "x": state.get("_x_input_parameters", []),
                    "prime": state.get("_x_prime_input_parameters", []),
                }
            else:
                state["_fwd_split"] = None
            if state.pop("_resolved_inverse_inputs", False):
                state["_inv_split"] = {
                    "x": state.get("_x_inverse_input_parameters", []),
                    "prime": state.get(
                        "_x_prime_inverse_input_parameters", []
                    ),
                }
            else:
                state["_inv_split"] = None
            for legacy in (
                "_x_input_parameters",
                "_x_prime_input_parameters",
                "_x_persistent_parameters",
                "_x_prime_persistent_parameters",
                "_x_inverse_input_parameters",
                "_x_prime_inverse_input_parameters",
            ):
                state.pop(legacy, None)
        self.__dict__.update(state)

    @property
    def name(self) -> str:
        return (
            type(self).__name__.lower()
            + "_"
            + "_".join(self.input_parameters)
        )

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        """Apply x -> x'. Must be implemented by subclasses."""
        raise NotImplementedError

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        """Apply x' -> x. Must be implemented by subclasses."""
        raise NotImplementedError

    def update(self, x, x_prime=None) -> None:
        """Update internal state (e.g. running bounds) from training data."""

    def reset(self) -> None:
        """Reset any data-driven state."""

    def update_bounds(self, x) -> None:
        """Alias kept for parity with the reference API."""

    def torch_inverse(self, cols: dict):
        """Device inverse x' -> x, or None where the class has none.

        ``cols`` maps parameter names (prime space, plus any x-space
        parameters written by reparameterisations applied earlier in the
        inverse order) to ``[n]`` float32 tensors on one device. Returns
        ``(updates, log_j)``: the x-space columns this reparameterisation
        produces and its ``log|dx/dx'|``. Every number (bounds, scales,
        detected edges) is read from the current state at each call, so
        an :meth:`update` is seen by the next populate. Counterpart of
        ``jax_inverse`` with ``jax_inverse_consts``; the flow proposal
        inverts on the host where a member of its stack returns None.
        """
        return None

    @property
    def has_torch_inverse(self) -> bool:
        """Whether :meth:`torch_inverse` runs on the device (the JAX
        package's ``jax_inverse() is not None``)."""
        return type(self).torch_inverse is not Reparameterisation.torch_inverse

    def torch_log_prior_fn(self):
        """Device counterpart of :meth:`log_prior` for the device populate
        loop: a function of the x-space columns (a dict of ``[n]``
        tensors) that returns the auxiliary parameters' log-prior, or None
        where the class has none. Consulted only where :attr:`has_prior`
        is set. Counterpart of ``jax_log_prior_fn``
        (``nessai_tpu/reparameterisations/base.py:440``)."""
        return None

    def x_prime_log_prior(self, x_prime):
        """Log-prior defined directly in the prime space (optional)."""
        raise RuntimeError(
            f"{type(self).__name__} does not have a prime prior"
        )

    def log_prior(self, x):
        """Additional log-prior contribution from auxiliary parameters."""
        return 0.0

    def __str__(self):
        return f"{type(self).__name__}({self.parameters})"
