"""Angle reparameterisations: periodic parameters mapped to Cartesian
coordinates with a (given or auxiliary chi-sampled) radial component.
Counterpart of ``nessai_tpu/reparameterisations/angle.py``, with each
device inverse (:meth:`torch_inverse`) in float32 torch ops.
"""

import logging
import math

import numpy as np
import torch
from scipy import stats

from ..utils.rescaling import (
    inverse_rescale_zero_to_one,
    rescale_zero_to_one,
)
from .base import Reparameterisation

logger = logging.getLogger(__name__)

__all__ = ["Angle", "ToCartesian", "AnglePair"]


class Angle(Reparameterisation):
    """Single angle → 2-D Cartesian, with a radial parameter (second entry
    of ``parameters``) or an auxiliary chi(2)-sampled radius.

    The polar→Cartesian Jacobian contributes ``log r``; an auxiliary
    radius contributes a chi(2) prior term via :meth:`log_prior`.
    """

    requires_bounded_prior = True
    one_to_one = False

    def __init__(
        self,
        parameters=None,
        prior_bounds=None,
        scale=1.0,
        prior=None,
        rng=None,
        **kwargs,
    ):
        super().__init__(
            parameters=parameters,
            prior_bounds=prior_bounds,
            rng=rng,
            **kwargs,
        )
        if len(self.parameters) == 1:
            self.auxiliary_parameters = [self.parameters[0] + "_radial"]
            self.chi = stats.chi(2)
            self.has_prior = True
        elif len(self.parameters) == 2:
            self.chi = None
            self.has_prior = False
        else:
            raise RuntimeError("Too many parameters for Angle")
        if scale is None:
            self.scale = 2.0 * np.pi / np.ptp(self.prior_bounds[self.angle])
        else:
            self.scale = float(scale)
        self._zero_bound = self.prior_bounds[self.angle][0] == 0
        self.prime_parameters = [self.angle + "_x", self.angle + "_y"]

    @property
    def angle(self):
        return self.parameters[0]

    @property
    def radial(self):
        if self.chi is not None:
            return self.auxiliary_parameters[0]
        return self.parameters[1]

    @property
    def radius(self):
        """Name of the radial parameter (alias of :attr:`radial`)."""
        return self.radial

    @property
    def x(self):
        """Name of the x prime coordinate."""
        return self.prime_parameters[0]

    @property
    def y(self):
        """Name of the y prime coordinate."""
        return self.prime_parameters[1]

    # hooks overridden by ToCartesian
    def _rescale_angle(self, x, x_prime, log_j, **kwargs):
        return (
            self.get_parameter_value(self.angle, x, x_prime) * self.scale,
            x,
            x_prime,
            log_j,
        )

    def _inverse_rescale_angle(self, x, x_prime, log_j):
        return x, x_prime, log_j

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        angle, x, x_prime, log_j = self._rescale_angle(
            x, x_prime, log_j, **kwargs
        )
        if self.chi is not None:
            r = self.chi.rvs(size=len(angle), random_state=self.rng)
        else:
            r = self.get_parameter_value(self.radial, x, x_prime)
        if np.any(r < 0):
            raise RuntimeError("Radius cannot be negative")
        x_prime[self.prime_parameters[0]] = r * np.cos(angle)
        x_prime[self.prime_parameters[1]] = r * np.sin(angle)
        log_j = log_j + np.log(r)
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        cx = np.asarray(x_prime[self.prime_parameters[0]], dtype=float)
        cy = np.asarray(x_prime[self.prime_parameters[1]], dtype=float)
        r = np.sqrt(cx**2 + cy**2)
        angle = np.arctan2(cy, cx)
        if self._zero_bound:
            angle = angle % (2.0 * np.pi)
        angle = angle / self.scale
        log_j = log_j - np.log(r)
        x, x_prime = self.set_parameter_value(self.radial, r, x, x_prime)
        x, x_prime = self.set_parameter_value(self.angle, angle, x, x_prime)
        x, x_prime, log_j = self._inverse_rescale_angle(x, x_prime, log_j)
        return x, x_prime, log_j

    def log_prior(self, x):
        """chi(2) prior on the auxiliary radius."""
        if self.chi is None:
            return 0.0
        return self.chi.logpdf(x[self.radial])

    def torch_log_prior_fn(self):
        """chi(2) prior on the auxiliary radius on the device:
        ``log r - r^2 / 2``."""
        if self.chi is None:
            return None
        radial = self.radial
        return lambda cols: torch.log(cols[radial]) - 0.5 * cols[radial] ** 2

    def torch_inverse(self, cols: dict):
        """Polar -> (angle, radius) on the columns' device: the radius,
        ``atan2`` (floor-modulo 2 pi for an angle bounded below at 0)
        over the scale, and ``log|dx/dx'| = -log r``."""
        cx, cy = cols[self.prime_parameters[0]], cols[self.prime_parameters[1]]
        scale = torch.tensor(self.scale, dtype=torch.float32, device=cx.device)
        r = torch.sqrt(cx**2 + cy**2)
        angle = torch.atan2(cy, cx)
        if self._zero_bound:
            angle = torch.remainder(angle, 2.0 * math.pi)
        angle = angle / scale
        return {self.radial: r, self.angle: angle}, -torch.log(r)


class ToCartesian(Angle):
    """Convert a *non-angular* bounded parameter to Cartesian coordinates
    by mapping it to an angle in [0, scale] first. Handles the boundary by
    'split' (random sign flip), 'duplicate' (mirror and double the batch)
    or 'half'.
    """

    def __init__(self, mode="split", scale=np.pi, **kwargs):
        super().__init__(scale=scale, **kwargs)
        if mode not in ("duplicate", "split", "half"):
            raise RuntimeError(f"Unknown mode: {mode}")
        self.mode = mode
        self._zero_bound = False

    def _rescale_angle(self, x, x_prime, log_j, compute_radius=False, **kwargs):
        angle, lj = rescale_zero_to_one(
            self.get_parameter_value(self.parameters[0], x, x_prime),
            *self.prior_bounds[self.parameters[0]],
        )
        log_j = log_j + lj
        if self.mode == "duplicate" or compute_radius:
            angle = np.concatenate([angle, -angle])
            x = np.concatenate([x, x])
            x_prime = np.concatenate([x_prime, x_prime])
            log_j = np.concatenate([log_j, log_j])
        elif self.mode == "split":
            neg = self.rng.choice(
                angle.size, angle.size // 2, replace=False
            )
            angle[neg] *= -1
        angle = angle * self.scale
        return angle, x, x_prime, log_j

    def _inverse_rescale_angle(self, x, x_prime, log_j):
        vals = np.abs(
            self.get_parameter_value(self.parameters[0], x, x_prime)
        )
        out, lj = inverse_rescale_zero_to_one(
            vals, *self.prior_bounds[self.parameters[0]]
        )
        log_j = log_j + lj
        x, x_prime = self.set_parameter_value(
            self.parameters[0], out, x, x_prime
        )
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        cx = np.asarray(x_prime[self.prime_parameters[0]], dtype=float)
        cy = np.asarray(x_prime[self.prime_parameters[1]], dtype=float)
        r = np.sqrt(cx**2 + cy**2)
        angle = np.arctan2(cy, cx) / self.scale
        log_j = log_j - np.log(r)
        x, x_prime = self.set_parameter_value(self.radial, r, x, x_prime)
        x, x_prime = self.set_parameter_value(
            self.parameters[0], angle, x, x_prime
        )
        x, x_prime, log_j = self._inverse_rescale_angle(x, x_prime, log_j)
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """Cartesian -> bounded parameter on the columns' device: |angle|
        is mapped back from [0, 1] to the prior bounds."""
        cx, cy = cols[self.prime_parameters[0]], cols[self.prime_parameters[1]]
        b = self.prior_bounds[self.parameters[0]]
        scale, b_lo, b_hi = torch.tensor(
            [self.scale, b[0], b[1]], dtype=torch.float32, device=cx.device
        )
        r = torch.sqrt(cx**2 + cy**2)
        angle = torch.atan2(cy, cx) / scale
        width = b_hi - b_lo
        out = torch.abs(angle) * width + b_lo
        log_j = -torch.log(r) + torch.log(width)
        return {self.radial: r, self.parameters[0]: out}, log_j


class AnglePair(Reparameterisation):
    """A pair of angles (+ optional radial) → 3-D Cartesian.

    Conventions: 'ra-dec' (dec ∈ [-π/2, π/2]) or 'az-zen' (zen ∈ [0, π]).
    Without a radial parameter the radius is chi(3)-sampled and carries a
    chi(3) prior.
    """

    requires_bounded_prior = True
    one_to_one = False
    known_conventions = ("ra-dec", "az-zen")

    def __init__(
        self,
        parameters=None,
        prior_bounds=None,
        convention=None,
        prior=None,
        rng=None,
        **kwargs,
    ):
        super().__init__(
            parameters=parameters,
            prior_bounds=prior_bounds,
            rng=rng,
            **kwargs,
        )
        if len(self.parameters) not in (2, 3):
            raise RuntimeError("AnglePair requires 2 or 3 parameters")

        # Order: horizontal angle (range 2pi) first, vertical second.
        angles = self.parameters[:2] if len(self.parameters) == 2 else None
        if angles is None:
            # find the radial: parameter whose prior range is not angular
            ranges = {
                p: np.ptp(self.prior_bounds[p]) for p in self.parameters
            }
            angular = [
                p
                for p in self.parameters
                if np.isclose(ranges[p], 2 * np.pi)
                or np.isclose(ranges[p], np.pi)
            ]
            if len(angular) != 2:
                raise RuntimeError(
                    "Could not identify the two angular parameters"
                )
            radial = [p for p in self.parameters if p not in angular][0]
            angles = angular
            self.parameters = angles + [radial]
            self.chi = None
            self.has_prior = False
        else:
            self.auxiliary_parameters = [self.parameters[0] + "_radial"]
            self.chi = stats.chi(3)
            self.has_prior = True

        # horizontal first
        if np.isclose(np.ptp(self.prior_bounds[angles[1]]), 2 * np.pi):
            angles = [angles[1], angles[0]]
        self._angles = angles

        if convention is None:
            b = self.prior_bounds[angles[1]]
            if np.isclose(b[0], -np.pi / 2) and np.isclose(b[1], np.pi / 2):
                convention = "ra-dec"
            elif np.isclose(b[0], 0) and np.isclose(b[1], np.pi):
                convention = "az-zen"
            else:
                raise RuntimeError(
                    f"Could not determine convention from bounds {b}"
                )
        if convention not in self.known_conventions:
            raise RuntimeError(f"Unknown convention: {convention}")
        self.convention = convention
        base = angles[0]
        self.prime_parameters = [base + "_x", base + "_y", base + "_z"]

    @property
    def angles(self):
        return self._angles

    @property
    def radial(self):
        if self.chi is not None:
            return self.auxiliary_parameters[0]
        return self.parameters[2]

    @property
    def x(self):
        """Name of the first Cartesian prime coordinate."""
        return self.prime_parameters[0]

    @property
    def y(self):
        """Name of the second Cartesian prime coordinate."""
        return self.prime_parameters[1]

    @property
    def z(self):
        """Name of the third Cartesian prime coordinate."""
        return self.prime_parameters[2]

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        alpha = self.get_parameter_value(self._angles[0], x, x_prime)
        beta = self.get_parameter_value(self._angles[1], x, x_prime)
        if self.chi is not None:
            r = self.chi.rvs(size=len(alpha), random_state=self.rng)
        else:
            r = self.get_parameter_value(self.radial, x, x_prime)
        if self.convention == "ra-dec":
            cx = r * np.cos(beta) * np.cos(alpha)
            cy = r * np.cos(beta) * np.sin(alpha)
            cz = r * np.sin(beta)
            log_j = log_j + 2 * np.log(r) + np.log(np.abs(np.cos(beta)))
        else:  # az-zen
            cx = r * np.sin(beta) * np.cos(alpha)
            cy = r * np.sin(beta) * np.sin(alpha)
            cz = r * np.cos(beta)
            log_j = log_j + 2 * np.log(r) + np.log(np.abs(np.sin(beta)))
        x_prime[self.prime_parameters[0]] = cx
        x_prime[self.prime_parameters[1]] = cy
        x_prime[self.prime_parameters[2]] = cz
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        cx = np.asarray(x_prime[self.prime_parameters[0]], dtype=float)
        cy = np.asarray(x_prime[self.prime_parameters[1]], dtype=float)
        cz = np.asarray(x_prime[self.prime_parameters[2]], dtype=float)
        r = np.sqrt(cx**2 + cy**2 + cz**2)
        alpha = np.arctan2(cy, cx) % (2 * np.pi)
        if self.convention == "ra-dec":
            beta = np.arctan2(cz, np.sqrt(cx**2 + cy**2))
            log_j = log_j - 2 * np.log(r) - np.log(np.abs(np.cos(beta)))
        else:
            beta = np.arctan2(np.sqrt(cx**2 + cy**2), cz)
            log_j = log_j - 2 * np.log(r) - np.log(np.abs(np.sin(beta)))
        x, x_prime = self.set_parameter_value(self.radial, r, x, x_prime)
        x, x_prime = self.set_parameter_value(self._angles[0], alpha, x, x_prime)
        x, x_prime = self.set_parameter_value(self._angles[1], beta, x, x_prime)
        return x, x_prime, log_j

    def log_prior(self, x):
        if self.chi is None:
            return 0.0
        return self.chi.logpdf(x[self.radial])

    def torch_log_prior_fn(self):
        """chi(3) prior on the auxiliary radius on the device:
        ``2 log r - r^2 / 2 + log sqrt(2 / pi)``."""
        if self.chi is None:
            return None
        radial = self.radial
        const = 0.5 * math.log(2.0 / math.pi)
        return lambda cols: 2.0 * torch.log(cols[radial]) - 0.5 * cols[radial] ** 2 + const

    def torch_inverse(self, cols: dict):
        """3-D Cartesian -> (alpha, beta, radius) on the columns' device,
        for both sky conventions."""
        cx, cy, cz = (cols[p] for p in self.prime_parameters)
        rho = torch.sqrt(cx**2 + cy**2)
        r = torch.sqrt(cx**2 + cy**2 + cz**2)
        alpha = torch.remainder(torch.atan2(cy, cx), 2.0 * math.pi)
        if self.convention == "ra-dec":
            beta = torch.atan2(cz, rho)
            log_j = -2.0 * torch.log(r) - torch.log(torch.abs(torch.cos(beta)))
        else:
            beta = torch.atan2(rho, cz)
            log_j = -2.0 * torch.log(r) - torch.log(torch.abs(torch.sin(beta)))
        return {self.radial: r, self._angles[0]: alpha, self._angles[1]: beta}, log_j
