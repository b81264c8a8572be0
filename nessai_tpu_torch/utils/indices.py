"""Insertion-index diagnostics. Counterpart of
``nessai_tpu/utils/indices.py``."""

import numpy as np

__all__ = ["bonferroni_correction", "compute_indices_ks_test"]


def compute_indices_ks_test(indices, nlive: int, mode: str = "D+"):
    """One-sided KS test of insertion indices against the uniform
    distribution on ``[0, nlive)``. Returns ``(D, p)``."""
    indices = np.asarray(indices)
    if not indices.size:
        return None, None
    counts = np.bincount(indices, minlength=nlive)
    ecdf = np.cumsum(counts) / indices.size
    uniform_cdf = np.arange(1, nlive + 1) / nlive
    if mode == "D+":
        D = np.max(uniform_cdf - ecdf)
    elif mode == "D-":
        D = np.max(ecdf - uniform_cdf)
    else:
        raise RuntimeError(f"Invalid mode: {mode}")
    p = np.exp(-2.0 * indices.size * D**2)
    return float(D), float(min(max(p, 0.0), 1.0))


def bonferroni_correction(p_values, alpha: float = 0.05):
    """The Bonferroni correction of ``p_values`` at level ``alpha``:
    ``(rejected, corrected p-values, corrected alpha)``."""
    p_values = np.asarray(p_values, dtype=float)
    n = len(p_values)
    corrected_alpha = alpha / n
    corrected_p = np.minimum(p_values * n, 1.0)
    rejected = p_values < corrected_alpha
    return rejected, corrected_p, corrected_alpha
