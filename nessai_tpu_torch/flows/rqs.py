"""Rational-quadratic spline transforms (Durkan et al. 2019,
arXiv:1906.04032): the plain PyTorch version.

Counterpart of ``nessai_tpu/flows/rqs.py``. CPU tensors run it through
the kernel wrapper (``ops/rqs.py``), and the tests and ``chip_smoke.py``
hold the CUDA kernels against it; nothing on the GPU path calls it.
"""

import math

import torch
from torch.nn import functional as F

__all__ = [
    "rational_quadratic_spline",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_MIN_DERIVATIVE",
    "derivative_shift",
    "n_derivatives",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def derivative_shift(min_derivative: float = DEFAULT_MIN_DERIVATIVE) -> float:
    """The constant added to the raw derivatives before the softplus, so
    that a raw value of zero gives a derivative of exactly 1 (the
    identity spline at a zero-initialised conditioner)."""
    return math.log(math.expm1(1.0 - min_derivative))


def n_derivatives(num_bins: int, tails="linear") -> int:
    """Raw knot derivatives per element: ``K - 1`` interior ones for
    linear tails, all ``K + 1`` for ``tails=None``."""
    if tails == "linear":
        return num_bins - 1
    if tails is None:
        return num_bins + 1
    raise ValueError(f"Unknown tails: {tails}")


def _normalise_bins(unnorm, num_bins, total, min_size):
    probs = torch.exp(unnorm - torch.amax(unnorm, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    probs = min_size + (1 - min_size * num_bins) * probs
    return probs * total


def _knots(sizes, low, high):
    """``[low, low + cumsum(sizes)[:-1], high]``: the last knot is pinned
    to ``high`` (the sum is ``high - low`` up to rounding)."""
    edge = sizes.new_full(sizes.shape[:-1] + (1,), low)
    inner = low + torch.cumsum(sizes[..., :-1], dim=-1)
    return torch.cat([edge, inner, sizes.new_full(edge.shape, high)], dim=-1)


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None])[..., 0]


def rational_quadratic_spline(
    inputs,
    unnormalised_widths,
    unnormalised_heights,
    unnormalised_derivatives,
    inverse: bool = False,
    tail_bound: float = 5.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    tails="linear",
):
    """Monotone rational-quadratic spline, elementwise over ``inputs``.

    With ``tails="linear"`` the spline lives on ``[-tail_bound,
    tail_bound]`` with identity tails, and ``unnormalised_derivatives``
    holds the ``K - 1`` interior knot derivatives (the boundary ones are
    1). With ``tails=None`` it maps ``[0, 1]`` onto ``[0, 1]`` and
    ``unnormalised_derivatives`` holds all ``K + 1``; inputs outside
    pass through unchanged.

    Shapes: ``inputs`` ``[...]``, widths and heights ``[..., K]``,
    derivatives ``[..., K - 1]`` or ``[..., K + 1]``. Returns
    ``(outputs, log_abs_det)``, both shaped as ``inputs``; the
    log-derivative is per element.
    """
    num_bins = unnormalised_widths.shape[-1]
    if tails == "linear":
        left = bottom = -tail_bound
        right = top = tail_bound
    elif tails is None:
        left = bottom = 0.0
        right = top = 1.0
    else:
        raise ValueError(f"Unknown tails: {tails}")

    inside = (inputs >= left) & (inputs <= right)
    # out-of-range inputs are replaced by the middle so the spline math
    # (and its gradient) stays finite; they are selected away below
    x = torch.where(inside, inputs, torch.full_like(inputs, 0.5 * (left + right)))

    widths = _normalise_bins(unnormalised_widths, num_bins, right - left, min_bin_width)
    heights = _normalise_bins(unnormalised_heights, num_bins, top - bottom, min_bin_height)
    cumwidths = _knots(widths, left, right)
    cumheights = _knots(heights, bottom, top)
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    derivatives = min_derivative + F.softplus(
        unnormalised_derivatives + derivative_shift(min_derivative)
    )
    if tails == "linear":
        ones = derivatives.new_ones(derivatives.shape[:-1] + (1,))
        derivatives = torch.cat([ones, derivatives, ones], dim=-1)

    # bin index: the number of interior knots at or below x
    ref = cumheights if inverse else cumwidths
    idx = torch.sum(x[..., None] >= ref[..., 1:-1], dim=-1)

    in_w = _take(widths, idx)
    in_cw = _take(cumwidths, idx)
    in_h = _take(heights, idx)
    in_ch = _take(cumheights, idx)
    d_k = _take(derivatives[..., :-1], idx)
    d_k1 = _take(derivatives[..., 1:], idx)
    s = in_h / in_w

    if inverse:
        # the stable root of the quadratic in theta (eq. 6-8 of the paper)
        y_rel = x - in_ch
        a = in_h * (s - d_k) + y_rel * (d_k + d_k1 - 2 * s)
        b = in_h * d_k - y_rel * (d_k + d_k1 - 2 * s)
        c = -s * y_rel
        disc = torch.clamp_min(b * b - 4 * a * c, 0.0)
        theta = (2 * c) / (-b - torch.sqrt(disc))
        theta = torch.clamp(theta, 0.0, 1.0)
        outputs = theta * in_w + in_cw
    else:
        theta = torch.clamp((x - in_cw) / in_w, 0.0, 1.0)
    denom = s + (d_k + d_k1 - 2 * s) * theta * (1 - theta)
    dydx_num = (s * s) * (
        d_k1 * (theta * theta) + 2 * s * theta * (1 - theta) + d_k * ((1 - theta) * (1 - theta))
    )
    log_det = torch.log(dydx_num) - 2 * torch.log(denom)
    if inverse:
        log_det = -log_det
    else:
        outputs = in_ch + in_h * (s * (theta * theta) + d_k * theta * (1 - theta)) / denom

    if tails is None:
        # rounding can put outputs a few ulp outside the box
        lo, hi = (left, right) if inverse else (bottom, top)
        outputs = torch.clamp(outputs, lo, hi)
    outputs = torch.where(inside, outputs, inputs)
    log_det = torch.where(inside, log_det, torch.zeros_like(log_det))
    return outputs, log_det
