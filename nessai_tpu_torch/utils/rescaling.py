"""Rescaling functions with log-Jacobians. Counterpart of
``nessai_tpu/utils/rescaling.py``.

The host functions are numpy in float64 and return ``(x_rescaled,
log_jacobian)``; :func:`get_torch_rescaling` gives the same maps as torch
ops for the flow proposal's device inverse.
"""

import logging

import numpy as np
from scipy.special import erf, erfinv

from .. import config

logger = logging.getLogger(__name__)

__all__ = [
    "rescale_zero_to_one",
    "inverse_rescale_zero_to_one",
    "rescale_minus_one_to_one",
    "inverse_rescale_minus_one_to_one",
    "logit",
    "sigmoid",
    "log_rescale",
    "log_inverse_rescale",
    "gaussian_cdf",
    "inverse_gaussian_cdf",
    "detect_edge",
    "configure_edge_detection",
    "determine_rescaled_bounds",
    "rescaling_functions",
    "get_torch_rescaling",
]


def rescale_zero_to_one(x, xmin, xmax):
    """Rescale ``[xmin, xmax] -> [0, 1]``."""
    width = xmax - xmin
    return (x - xmin) / width, -np.log(width) * np.ones_like(x)


def inverse_rescale_zero_to_one(x, xmin, xmax):
    width = xmax - xmin
    return x * width + xmin, np.log(width) * np.ones_like(x)


def rescale_minus_one_to_one(x, xmin, xmax):
    """Rescale ``[xmin, xmax] -> [-1, 1]``."""
    width = xmax - xmin
    return 2.0 * (x - xmin) / width - 1.0, (np.log(2) - np.log(width)) * np.ones_like(x)


def inverse_rescale_minus_one_to_one(x, xmin, xmax):
    width = xmax - xmin
    return (x + 1.0) * width / 2.0 + xmin, (np.log(width) - np.log(2)) * np.ones_like(x)


def logit(x, eps=None):
    """Logit with epsilon clipping and log-Jacobian."""
    if eps is None:
        eps = config.general.eps
    x = np.clip(x, eps, 1.0 - eps)
    log_j = -np.log(x) - np.log1p(-x)
    return np.log(x) - np.log1p(-x), log_j


def sigmoid(x):
    """Sigmoid with log-Jacobian."""
    y = np.divide(1.0, 1.0 + np.exp(-x))
    log_j = np.log(y) + np.log1p(-y)
    return y, log_j


def log_rescale(x):
    """Natural log with Jacobian (for positive parameters)."""
    return np.log(x), -np.log(x)


def log_inverse_rescale(x):
    return np.exp(x), x.copy() if hasattr(x, "copy") else np.asarray(x)


def gaussian_cdf(x):
    """Standard normal CDF with log-Jacobian."""
    y = 0.5 * (1.0 + erf(x / np.sqrt(2.0)))
    log_j = -0.5 * x**2 - 0.5 * np.log(2 * np.pi)
    return y, log_j


def inverse_gaussian_cdf(x):
    y = np.sqrt(2.0) * erfinv(2.0 * x - 1.0)
    log_j = 0.5 * y**2 + 0.5 * np.log(2 * np.pi)
    return y, log_j


def detect_edge(
    x,
    x_range=None,
    percent: float = 0.1,
    cutoff: float = 0.5,
    nbins="auto",
    allow_both: bool = False,
    allow_none: bool = False,
    allowed_bounds=None,
    test=None,
):
    """Detect whether the density of ``x`` piles up at its lower and/or
    upper bound, used to configure boundary inversion.

    Returns one of ``'lower'``, ``'upper'``, ``'both'`` (if allowed),
    ``False`` (if none detected and allowed), or the denser bound.
    """
    if allowed_bounds is None:
        allowed_bounds = ["lower", "upper"]
    else:
        allowed_bounds = list(allowed_bounds)
        unknown = [b for b in allowed_bounds if b not in ("lower", "upper")]
        if unknown:
            raise RuntimeError(f"Unknown allowed bounds: {unknown}")
    if test is not None:
        if test in allowed_bounds or test in ("both", False):
            return test
        return False
    x = np.asarray(x).ravel()
    if nbins == "auto":
        from .hist import auto_bins

        nbins = auto_bins(x)
    hist, bins = np.histogram(x, bins=nbins, range=x_range, density=True)
    n = max(int(percent * nbins), 1)
    bounds = {"lower": np.max(hist[:n]), "upper": np.max(hist[-n:])}
    max_density = np.max(hist)
    for b in ("lower", "upper"):
        if b not in allowed_bounds:
            bounds.pop(b)
    above = {k: v for k, v in bounds.items() if v >= cutoff * max_density}
    if len(above) == 2 and allow_both:
        return "both"
    if not above:
        if allow_none:
            return False
        # fall back to the denser bound
        return max(bounds, key=bounds.get) if bounds else False
    return max(above, key=above.get)


def configure_edge_detection(d: dict, detect_edges: bool) -> dict:
    """Normalise edge-detection kwargs."""
    if d is None:
        d = {}
    if detect_edges:
        d.setdefault("allow_none", True)
        d.setdefault("cutoff", 0.5)
    else:
        d["allow_none"] = False
        d["cutoff"] = 0.0
    return d


def determine_rescaled_bounds(
    prior_min,
    prior_max,
    x_min,
    x_max,
    invert=None,
    inversion: bool = False,
    offset: float = 0.0,
    rescale_bounds=None,
):
    """Bounds of the prime space given data bounds and inversion setting.

    With ``inversion=True`` the rescaling is assumed to map onto
    ``[0, 1]`` (``rescale_bounds`` is ignored, as in ``RescaleToBounds``)
    and the inverted ranges follow the reflect-at-the-edge convention.
    """
    if x_min == x_max:
        raise ValueError("New minimum and maximum are equal")
    if rescale_bounds is None:
        rescale_bounds = [-1, 1]
    if not inversion:
        scale = rescale_bounds[1] - rescale_bounds[0]
        shift = rescale_bounds[0]
    else:
        scale = 1.0
        shift = 0.0
    lo = scale * (prior_min - offset - x_min) / (x_max - x_min) + shift
    hi = scale * (prior_max - offset - x_min) / (x_max - x_min) + shift
    if not inversion:
        if invert:
            logger.warning("`invert` is not False or None, but `inversion=False`")
        return lo, hi
    if invert is None or invert is False:
        return 2 * lo - 1, 2 * hi - 1
    if invert == "upper":
        return lo - 1, 1 - lo
    if invert == "lower":
        return -hi, hi
    if invert == "both":
        return -0.5, 1.5
    raise ValueError(f"Invalid value for `invert`: {invert}")


rescaling_functions = {
    "logit": (logit, sigmoid),
    "log": (log_rescale, log_inverse_rescale),
    "gaussian_cdf": (gaussian_cdf, inverse_gaussian_cdf),
    "inv_gaussian_cdf": (inverse_gaussian_cdf, gaussian_cdf),
}


def _t_logit(x):
    eps = config.general.eps
    x = x.clamp(eps, 1.0 - eps)
    log_j = -x.log() - (-x).log1p()
    return x.log() - (-x).log1p(), log_j


def _t_sigmoid(x):
    y = 1.0 / (1.0 + (-x).exp())
    return y, y.log() + (-y).log1p()


def _t_log(x):
    return x.log(), -x.log()


def _t_exp(x):
    return x.exp(), x


_HALF_LOG_2PI = 0.5 * np.log(2 * np.pi)


def _t_gaussian_cdf(x):
    import torch

    return torch.special.ndtr(x), -0.5 * x**2 - _HALF_LOG_2PI


def _t_inverse_gaussian_cdf(x):
    import torch

    y = torch.special.ndtri(x)
    return y, 0.5 * y**2 + _HALF_LOG_2PI


_TORCH_RESCALINGS = {
    "logit": (_t_logit, _t_sigmoid),
    "log": (_t_log, _t_exp),
    "gaussian_cdf": (_t_gaussian_cdf, _t_inverse_gaussian_cdf),
    "inv_gaussian_cdf": (_t_inverse_gaussian_cdf, _t_gaussian_cdf),
}


def get_torch_rescaling(name: str):
    """The (forward, inverse) pair of :data:`rescaling_functions`' entry
    ``name`` as torch ops on the input's device and dtype, or None for
    an unknown name. Counterpart of ``get_jax_rescaling``."""
    return _TORCH_RESCALINGS.get(name)
