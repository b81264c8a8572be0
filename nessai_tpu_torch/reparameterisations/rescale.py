"""Rescaling reparameterisations. Counterpart of
``nessai_tpu/reparameterisations/rescale.py``: ``ScaleAndShift``
(z-score), ``Rescale`` and ``RescaleToBounds`` with live bound updates,
offsets, pre/post rescaling and boundary inversion, each with a device
inverse (:meth:`torch_inverse`) in float32 torch ops.
"""

import logging
import math

import numpy as np
import torch

from ..utils.rescaling import (
    configure_edge_detection,
    detect_edge,
    get_torch_rescaling,
    rescaling_functions,
)
from .base import Reparameterisation

logger = logging.getLogger(__name__)

__all__ = [
    "PrePostRescalingMixin",
    "ScaleAndShift",
    "Rescale",
    "RescaleToBounds",
]


def _f32(values, device):
    """Per-parameter constants as a float32 tensor on ``device``."""
    return torch.tensor(values, dtype=torch.float32, device=device)


class PrePostRescalingMixin:
    """Optional elementwise pre/post rescaling functions with
    log-Jacobians (logit, log, gaussian_cdf, ...)."""

    #: Names of the pre/post rescalings when given as registry strings
    #: (None for custom callables), which the device inverse needs.
    pre_rescaling_name = None
    post_rescaling_name = None
    has_pre_rescaling = False
    has_post_rescaling = False

    # identity defaults; configuring a rescaling shadows these with
    # instance attributes
    def pre_rescaling(self, x):
        """Function applied before the main rescaling."""
        return x.copy(), np.zeros_like(x)

    def pre_rescaling_inv(self, x):
        """Inverse of the function applied before the main rescaling."""
        return x.copy(), np.zeros_like(x)

    def post_rescaling(self, x):
        """Function applied after the main rescaling."""
        return x, np.zeros_like(x)

    def post_rescaling_inv(self, x):
        """Inverse of the function applied after the main rescaling."""
        return x, np.zeros_like(x)

    def _configure_rescaling(self, label, attr, value):
        if value is None:
            setattr(self, "has_" + attr, False)
            return
        if isinstance(value, str):
            pair = rescaling_functions.get(value)
            if pair is None:
                raise RuntimeError(f"Unknown rescaling function: {value}")
            setattr(self, attr, pair[0])
            setattr(self, attr + "_inv", pair[1])
            setattr(self, attr + "_name", value)
        elif isinstance(value, (tuple, list)) and len(value) == 2:
            setattr(self, attr, value[0])
            setattr(self, attr + "_inv", value[1])
            setattr(self, attr + "_name", None)
        else:
            raise RuntimeError(
                f"{label} must be a str or tuple of two functions, got: {value}"
            )
        setattr(self, "has_" + attr, True)

    def configure_pre_rescaling(self, pre_rescaling):
        """Configure the rescaling applied before the main rescaling."""
        self._configure_rescaling("Pre-rescaling", "pre_rescaling", pre_rescaling)

    def configure_post_rescaling(self, post_rescaling):
        """Configure the rescaling applied after the main rescaling."""
        self._configure_rescaling("Post-rescaling", "post_rescaling", post_rescaling)

    def _torch_pre_post_inverses(self):
        """(pre_inv, post_inv) as torch functions (None where not
        configured), or None if a custom (non-registry) rescaling keeps
        the inverse on the host."""
        fns = []
        for has, name in (
            (self.has_pre_rescaling, self.pre_rescaling_name),
            (self.has_post_rescaling, self.post_rescaling_name),
        ):
            if not has:
                fns.append(None)
            elif name is None:
                return None
            else:
                fns.append(get_torch_rescaling(name)[1])
        return tuple(fns)

    @property
    def has_torch_inverse(self) -> bool:
        """A custom (non-registry) rescaling keeps the inverse on the host."""
        return self._torch_pre_post_inverses() is not None

    def _apply_pre(self, x):
        if not self.has_pre_rescaling:
            return x, np.zeros_like(x)
        return self.pre_rescaling(x)

    def _apply_pre_inv(self, x):
        if not self.has_pre_rescaling:
            return x, np.zeros_like(x)
        return self.pre_rescaling_inv(x)

    def _apply_post(self, x):
        if not self.has_post_rescaling:
            return x, np.zeros_like(x)
        return self.post_rescaling(x)

    def _apply_post_inv(self, x):
        if not self.has_post_rescaling:
            return x, np.zeros_like(x)
        return self.post_rescaling_inv(x)


class ScaleAndShift(Reparameterisation, PrePostRescalingMixin):
    """x' = (pre(x) - shift) / scale, optionally estimated (z-score) from
    the training data on each :meth:`update`."""

    # ahead of Reparameterisation's in the method order
    has_torch_inverse = PrePostRescalingMixin.has_torch_inverse

    def __init__(
        self,
        parameters=None,
        prior_bounds=None,
        scale=None,
        shift=None,
        estimate: bool = False,
        estimate_scale: bool = False,
        estimate_shift: bool = False,
        pre_rescaling=None,
        post_rescaling=None,
        rng=None,
        **kwargs,
    ):
        super().__init__(parameters=parameters, prior_bounds=prior_bounds, rng=rng, **kwargs)
        self.estimate_scale = estimate_scale or estimate
        self.estimate_shift = estimate_shift or estimate
        self.estimate = self.estimate_scale or self.estimate_shift
        self.configure_pre_rescaling(pre_rescaling)
        self.configure_post_rescaling(post_rescaling)
        if scale is None and not self.estimate_scale:
            raise RuntimeError("Must specify a scale or enable estimate_scale")
        self.scale = self._per_param(scale, 1.0, name="scale")
        self.shift = self._per_param(shift, 0.0, name="shift")

    def _per_param(self, value, default, name="scale"):
        """Normalise a scalar / list / dict input to a per-parameter dict."""
        if value is None:
            return {p: float(default) for p in self.parameters}
        if isinstance(value, dict):
            if set(value.keys()) != set(self.parameters):
                raise RuntimeError(
                    f"Mismatched parameters with {name} dictionary: "
                    f"{list(value.keys())} vs {self.parameters}"
                )
            return {p: float(value[p]) for p in self.parameters}
        if isinstance(value, (int, float, np.integer, np.floating)):
            return {p: float(value) for p in self.parameters}
        if isinstance(value, (list, tuple, np.ndarray)):
            value = np.asarray(value, dtype=float).ravel()
            if len(value) != len(self.parameters):
                raise RuntimeError(
                    f"{name} list is a different length to the number of "
                    f"parameters: {len(value)} vs {len(self.parameters)}"
                )
            return {p: float(v) for p, v in zip(self.parameters, value)}
        raise TypeError(
            f"{name} input must be an instance of int, float, list or "
            f"dict, got: {type(value).__name__}"
        )

    def update(self, x, x_prime=None) -> None:
        if not self.estimate:
            return
        for p in self.parameters:
            vals, _ = self._apply_pre(np.asarray(x[p], dtype=float))
            if self.estimate_scale:
                self.scale[p] = float(np.std(vals)) or 1.0
            if self.estimate_shift:
                self.shift[p] = float(np.mean(vals))

    def reset(self) -> None:
        """Reset estimated scales/shifts to their initial values."""
        if self.estimate_scale:
            self.scale = {p: 1.0 for p in self.parameters}
        if self.estimate_shift:
            self.shift = {p: 0.0 for p in self.parameters}

    def as_affine(self):
        """Each parameter's ``(scale, shift)`` of the inverse map ``x = x'
        scale + shift``, where the map is affine alone (no pre- or
        post-rescaling), else None."""
        if self.has_pre_rescaling or self.has_post_rescaling:
            return None
        return {p: (float(self.scale[p]), float(self.shift[p])) for p in self.parameters}

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            vals, lj_pre = self._apply_pre(np.asarray(x[p], dtype=float))
            out = (vals - self.shift[p]) / self.scale[p]
            lj = -np.log(abs(self.scale[p])) * np.ones_like(out)
            out, lj_post = self._apply_post(out)
            x_prime[pp] = out
            log_j = log_j + lj_pre + lj + lj_post
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            vals, lj_post = self._apply_post_inv(np.asarray(x_prime[pp], dtype=float))
            out = vals * self.scale[p] + self.shift[p]
            lj = np.log(abs(self.scale[p])) * np.ones_like(out)
            out, lj_pre = self._apply_pre_inv(out)
            x[p] = out
            log_j = log_j + lj_post + lj + lj_pre
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """``x = pre_inv(post_inv(x') * scale + shift)`` in float32 on the
        columns' device, with the current (per-training) scale and
        shift."""
        fns = self._torch_pre_post_inverses()
        if fns is None:
            return None
        pre_inv, post_inv = fns
        device = next(iter(cols.values())).device
        scale = _f32([self.scale[p] for p in self.parameters], device)
        shift = _f32([self.shift[p] for p in self.parameters], device)
        log_j = 0.0
        updates = {}
        for i, (p, pp) in enumerate(zip(self.parameters, self.prime_parameters)):
            v = cols[pp]
            if post_inv is not None:
                v, lj_post = post_inv(v)
                log_j = log_j + lj_post
            out = v * scale[i] + shift[i]
            log_j = log_j + torch.log(torch.abs(scale[i]))
            if pre_inv is not None:
                out, lj_pre = pre_inv(out)
                log_j = log_j + lj_pre
            updates[p] = out
        return updates, log_j


class Rescale(ScaleAndShift):
    """Scale-only variant (shift = 0)."""

    def __init__(self, parameters=None, prior_bounds=None, scale=None, rng=None, **kwargs):
        if scale is None:
            raise RuntimeError("Must specify a scale")
        super().__init__(
            parameters=parameters,
            prior_bounds=prior_bounds,
            scale=scale,
            shift=None,
            estimate=False,
            **kwargs,
            rng=rng,
        )


class RescaleToBounds(Reparameterisation, PrePostRescalingMixin):
    """Map prior bounds to ``rescale_bounds`` (default [-1, 1]) with
    optional live bound updates, per-parameter offsets, pre/post
    rescaling and boundary inversion."""

    # ahead of Reparameterisation's in the method order
    has_torch_inverse = PrePostRescalingMixin.has_torch_inverse

    requires_bounded_prior = True

    def __init__(
        self,
        parameters=None,
        prior_bounds=None,
        rescale_bounds=None,
        update_bounds: bool = True,
        offset: bool = False,
        boundary_inversion=None,
        detect_edges: bool = False,
        detect_edges_kwargs=None,
        inversion_type: str = "split",
        prior=None,
        pre_rescaling=None,
        post_rescaling=None,
        rng=None,
        **kwargs,
    ):
        super().__init__(parameters=parameters, prior_bounds=prior_bounds, rng=rng, **kwargs)
        if rescale_bounds is None:
            self.rescale_bounds = {p: [-1.0, 1.0] for p in self.parameters}
        elif isinstance(rescale_bounds, dict):
            missing = set(self.parameters) - set(rescale_bounds.keys())
            if missing:
                raise RuntimeError(f"Missing rescale bounds for parameters: {missing}")
            self.rescale_bounds = {p: list(map(float, rescale_bounds[p])) for p in self.parameters}
        elif isinstance(rescale_bounds, (list, tuple)):
            self.rescale_bounds = {p: list(map(float, rescale_bounds)) for p in self.parameters}
        else:
            raise TypeError(
                "rescale_bounds must be an instance of list or dict. "
                f"Got type: {type(rescale_bounds).__name__}"
            )

        if inversion_type not in ("split", "duplicate"):
            raise RuntimeError(f"Unknown inversion type: {inversion_type}")
        self.inversion_type = inversion_type
        # list / dict (per-parameter inversion type) / bool forms; the
        # attribute is False or a dict
        if boundary_inversion is None or boundary_inversion is False:
            self.boundary_inversion = False
        elif boundary_inversion is True:
            self.boundary_inversion = {p: inversion_type for p in self.parameters}
        elif isinstance(boundary_inversion, dict):
            self.boundary_inversion = dict(boundary_inversion)
        elif isinstance(boundary_inversion, (list, tuple)):
            self.boundary_inversion = {p: inversion_type for p in boundary_inversion}
        else:
            raise TypeError(
                "boundary_inversion must be a list, dict or bool. "
                f"Got type: {type(boundary_inversion).__name__}"
            )
        bad = {
            p: t
            for p, t in (self.boundary_inversion or {}).items()
            if t not in ("split", "duplicate")
        }
        if bad:
            raise RuntimeError(f"Unknown inversion type: {bad}")
        unknown = set(self.boundary_inversion or {}) - set(self.parameters)
        if unknown:
            raise RuntimeError(f"Unknown inversion parameters: {unknown}")
        # inversion parameters are always rescaled to [0, 1]
        for p in self.boundary_inversion or {}:
            self.rescale_bounds[p] = [0.0, 1.0]
        self._update = update_bounds if not detect_edges else True
        self.detect_edges = detect_edges
        if detect_edges and not self.boundary_inversion:
            raise RuntimeError("Must enable boundary inversion to use detect edges")
        self.detect_edges_kwargs = configure_edge_detection(detect_edges_kwargs, detect_edges)
        self._edges = {p: None for p in self.parameters} if self.boundary_inversion else None
        self.configure_post_rescaling_bounds(post_rescaling)
        self.prior = prior
        self.has_prime_prior = prior == "uniform" and not self.boundary_inversion and not self._update

        self.configure_pre_rescaling(pre_rescaling)
        # pre-rescaled prior bounds
        self.pre_prior_bounds = {p: self._apply_pre(self.prior_bounds[p])[0] for p in self.parameters}
        if offset:
            self.offsets = {
                p: float(self.pre_prior_bounds[p][0] + 0.5 * np.ptp(self.pre_prior_bounds[p]))
                for p in self.parameters
            }
        else:
            self.offsets = {p: 0.0 for p in self.parameters}
        self.bounds = {p: self.pre_prior_bounds[p] - self.offsets[p] for p in self.parameters}

    @property
    def _inversion_types(self):
        """Per-parameter inversion types (empty dict when disabled)."""
        return self.boundary_inversion or {}

    def configure_post_rescaling_bounds(self, post_rescaling):
        """Configure the post-rescaling: log/logit need fixed bounds and
        put the main rescaling onto [0, 1]."""
        self._configure_rescaling("Post-rescaling", "post_rescaling", post_rescaling)
        if post_rescaling is not None and post_rescaling in ("logit", "log"):
            if self._update:
                raise RuntimeError("Cannot use log or logit with update bounds")
            logger.debug("Setting bounds to [0, 1] for log/logit")
            self.rescale_bounds = {p: [0.0, 1.0] for p in self.parameters}

    configure_post_rescaling = configure_post_rescaling_bounds

    def _rescale_to_bounds(self, x, p):
        lo, hi = self.bounds[p]
        rb = self.rescale_bounds[p]
        out = (rb[1] - rb[0]) * (x - lo) / (hi - lo) + rb[0]
        log_j = np.log(rb[1] - rb[0]) - np.log(hi - lo)
        return out, log_j * np.ones_like(out)

    def _inverse_rescale_to_bounds(self, x, p):
        lo, hi = self.bounds[p]
        rb = self.rescale_bounds[p]
        out = (hi - lo) * (x - rb[0]) / (rb[1] - rb[0]) + lo
        log_j = np.log(hi - lo) - np.log(rb[1] - rb[0])
        return out, log_j * np.ones_like(out)

    @property
    def update_bounds_enabled(self) -> bool:
        """Whether :meth:`update` moves the bounds."""
        return self._update

    def update_bounds(self, x, x_prime=None) -> None:
        """Update the data-driven bounds (a no-op when updates are
        disabled)."""
        if self._update:
            for p in self.parameters:
                vals, _ = self._apply_pre(np.asarray(x[p], dtype=float))
                vals = vals - self.offsets[p]
                self.bounds[p] = np.array([vals.min(), vals.max()])
            logger.debug("New bounds: %s", self.bounds)
        else:
            logger.debug("Update bounds not enabled")

    def update(self, x, x_prime=None) -> None:
        """Refresh data-driven bounds and reset edge detection."""
        self.update_bounds(x, x_prime=x_prime)
        self.reset_inversion()

    def reset(self) -> None:
        """Reset the inversion and the bounds."""
        self.reset_inversion()
        self.set_bounds(self.prior_bounds)

    def reset_inversion(self) -> None:
        """Clear detected edges only."""
        if self._edges:
            self._edges = {p: None for p in self.parameters}

    def set_bounds(self, prior_bounds: dict) -> None:
        """Set bounds explicitly from prior bounds."""
        self.pre_prior_bounds = {
            p: self._apply_pre(np.asarray(prior_bounds[p], dtype=float))[0] for p in self.parameters
        }
        self.bounds = {p: self.pre_prior_bounds[p] - self.offsets[p] for p in self.parameters}

    def reparameterise(self, x, x_prime, log_j, compute_radius=False, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            vals, lj_pre = self._apply_pre(np.asarray(x[p], dtype=float))
            vals = vals - self.offsets[p]
            if self.boundary_inversion and p in self.boundary_inversion:
                x, x_prime, log_j, vals_out, lj = self._apply_inversion(
                    x, x_prime, log_j, p, vals, compute_radius
                )
                x_prime[pp] = vals_out
                log_j = log_j + lj + self._tile(lj_pre, len(log_j))
            else:
                out, lj = self._rescale_to_bounds(vals, p)
                out, lj_post = self._apply_post(out)
                x_prime[pp] = out
                log_j = log_j + lj_pre + lj + lj_post
        return x, x_prime, log_j

    @staticmethod
    def _tile(arr, n):
        arr = np.asarray(arr)
        if len(arr) == n:
            return arr
        return np.tile(arr, n // len(arr))

    def _apply_inversion(self, x, x_prime, log_j, p, vals, compute_radius):
        """Boundary inversion: rescale to [0, 1], then reflect at the
        detected edge ('split': a random half negated in place, drawn
        from ``self.rng``; 'duplicate': append the mirrored copy,
        doubling the arrays). When no edge is detected the parameter
        falls through to a plain [-1, 1] rescale, mirrored exactly by
        the inverse."""
        lo, hi = self.bounds[p]
        if self._edges[p] is None:
            self._edges[p] = detect_edge((vals - lo) / (hi - lo), **self.detect_edges_kwargs)
        edge = self._edges[p]
        if not edge:
            out = 2.0 * (vals - lo) / (hi - lo) - 1.0
            lj = (np.log(2.0) - np.log(hi - lo)) * np.ones_like(out)
            return x, x_prime, log_j, out, lj
        out = (vals - lo) / (hi - lo)
        lj = -np.log(hi - lo) * np.ones_like(out)
        if edge == "upper":
            out = 1.0 - out
        if self._inversion_types[p] == "duplicate" or compute_radius:
            x = np.concatenate([x, x])
            x_prime = np.concatenate([x_prime, x_prime])
            log_j = np.concatenate([log_j, log_j])
            lj = np.concatenate([lj, lj])
            out = np.concatenate([out, -out])
        else:
            mask = self.rng.random(len(out)) < 0.5
            out[mask] *= -1.0
        return x, x_prime, log_j, out, lj

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            vals = np.asarray(x_prime[pp], dtype=float).copy()
            if self._inversion_types and p in self._inversion_types and self._edges.get(p):
                vals = np.abs(vals)
                if self._edges[p] == "upper":
                    vals = 1.0 - vals
                lo, hi = self.bounds[p]
                out = vals * (hi - lo) + lo
                lj = np.log(hi - lo) * np.ones_like(out)
            elif self._inversion_types and p in self._inversion_types:
                # no edge detected: mirror of the plain [-1, 1] rescale
                lo, hi = self.bounds[p]
                out = (vals + 1.0) * (hi - lo) / 2.0 + lo
                lj = (np.log(hi - lo) - np.log(2.0)) * np.ones_like(out)
            else:
                vals, lj_post = self._apply_post_inv(vals)
                out, lj = self._inverse_rescale_to_bounds(vals, p)
                lj = lj + lj_post
            out = out + self.offsets[p]
            out, lj_pre = self._apply_pre_inv(out)
            x[p] = out
            log_j = log_j + lj + lj_pre
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """The inverse in float32 on the columns' device, with the live
        bounds, offsets, rescale bounds and detected edges of the current
        state: |v|, flipped for an upper edge, for an inverted parameter
        with an edge; the plain [-1, 1] map for one without; otherwise
        the post-rescaling's inverse and the map from the rescale
        bounds. Then the offset and the pre-rescaling's inverse."""
        fns = self._torch_pre_post_inverses()
        if fns is None:
            return None
        pre_inv, post_inv = fns
        device = next(iter(cols.values())).device
        params = self.parameters
        lo = _f32([self.bounds[p][0] for p in params], device)
        hi = _f32([self.bounds[p][1] for p in params], device)
        offset = _f32([self.offsets[p] for p in params], device)
        rb0 = _f32([self.rescale_bounds[p][0] for p in params], device)
        rb1 = _f32([self.rescale_bounds[p][1] for p in params], device)
        edges = self._edges or {}
        log_j = 0.0
        updates = {}
        for i, (p, pp) in enumerate(zip(params, self.prime_parameters)):
            v = cols[pp]
            width = hi[i] - lo[i]
            if p in self._inversion_types:
                edge = edges.get(p)
                if edge:
                    va = torch.abs(v)
                    if edge == "upper":
                        va = 1.0 - va
                    out = va * width + lo[i]
                    log_j = log_j + torch.log(width)
                else:
                    out = (v + 1.0) * width / 2.0 + lo[i]
                    log_j = log_j + (torch.log(width) - math.log(2.0))
            else:
                if post_inv is not None:
                    v, lj_post = post_inv(v)
                    log_j = log_j + lj_post
                out = width * (v - rb0[i]) / (rb1[i] - rb0[i]) + lo[i]
                log_j = log_j + torch.log(width) - torch.log(rb1[i] - rb0[i])
            out = out + offset[i]
            if pre_inv is not None:
                out, lj_pre = pre_inv(out)
                log_j = log_j + lj_pre
            updates[p] = out
        return updates, log_j

    def x_prime_log_prior(self, x_prime):
        """Uniform prime prior when bounds are fixed (prior='uniform')."""
        if not self.has_prime_prior:
            raise RuntimeError(
                "Prime prior not available (requires prior='uniform' and no boundary inversion)"
            )
        log_p = 0.0
        for p, pp in zip(self.parameters, self.prime_parameters):
            rb = self.rescale_bounds[p]
            vals = x_prime[pp]
            inside = (vals >= rb[0]) & (vals <= rb[1])
            log_p = log_p + np.where(inside, -np.log(rb[1] - rb[0]), -np.inf)
        return log_p
