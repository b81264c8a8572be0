"""Statistics helpers. Counterpart of ``nessai_tpu/utils/stats.py``
(``effective_sample_size``, ``rolling_mean`` and ``weighted_quantile``,
numpy and scipy as there)."""

import numpy as np
from scipy.special import betainc, logsumexp

__all__ = ["effective_sample_size", "rolling_mean", "weighted_quantile"]


def effective_sample_size(log_w: np.ndarray) -> float:
    """Kish effective sample size from log-weights."""
    log_w = np.asarray(log_w, dtype=float)
    if not log_w.size:
        return np.nan
    return float(np.exp(2 * logsumexp(log_w) - logsumexp(2 * log_w)))


def rolling_mean(x: np.ndarray, N: int = 10) -> np.ndarray:
    """The mean over a window of ``N`` points, the ends padded with the
    first and last values so the output has the input's length."""
    x = np.asarray(x, dtype=float)
    padded = np.concatenate([np.full(N // 2, x[0]), x, np.full(N - N // 2 - 1, x[-1])])
    return np.convolve(padded, np.ones(N) / N, mode="valid")


def weighted_quantile(
    values,
    quantiles,
    log_weights=None,
    values_sorted: bool = False,
) -> np.ndarray:
    """Weighted Harrell-Davis quantile estimator.

    Uses the incomplete beta function to weight order statistics; supports
    log-weights.
    """
    values = np.asarray(values, dtype=float)
    scalar = np.isscalar(quantiles)
    quantiles = np.atleast_1d(np.asarray(quantiles, dtype=float))
    if np.any((quantiles < 0) | (quantiles > 1)):
        raise ValueError("Quantiles should be in [0, 1]")
    if log_weights is None:
        log_weights = np.zeros(len(values))
    log_weights = np.asarray(log_weights, dtype=float)

    if not values_sorted:
        order = np.argsort(values)
        values = values[order]
        log_weights = log_weights[order]

    # normalised cumulative weights
    log_norm = logsumexp(log_weights)
    w = np.exp(log_weights - log_norm)
    # clip: the cumsum can overshoot 1 by float eps, which puts betainc
    # outside its domain (returns nan)
    cdf = np.clip(np.cumsum(w), 0.0, 1.0)
    cdf_prev = np.clip(cdf - w, 0.0, 1.0)
    n = effective_sample_size(log_weights)
    if not np.isfinite(n):
        raise ValueError(
            "Effective sample size is not finite; cannot compute the "
            "weighted quantile"
        )

    out = np.empty(len(quantiles))
    for i, q in enumerate(quantiles):
        a = q * (n + 1)
        b = (1 - q) * (n + 1)
        wi = betainc(a, b, cdf) - betainc(a, b, cdf_prev)
        out[i] = np.sum(wi * values)
    return out[0] if scalar else out
