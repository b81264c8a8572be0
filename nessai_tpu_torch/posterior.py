"""Posterior samples from nested samples. Counterpart of
``nessai_tpu/posterior.py``."""

import numpy as np

from .evidence import log_integrate_log_trap, logsubexp

__all__ = ["compute_weights", "draw_posterior_samples"]


def compute_weights(samples, nlive):
    """Log posterior weights of a chain of nested samples. ``nlive`` is
    an int (the final ``nlive`` points are consumed with nlive, ..., 1)
    or an array per sample. Returns ``(log_z, log_w)``."""
    samples = np.asarray(samples, dtype=float)
    n = len(samples)
    if isinstance(nlive, (int, np.integer, float)):
        nlive = int(nlive)
        nlive_per_it = np.full(n, float(nlive))
        nlive_per_it[-nlive:] = np.arange(min(nlive, n), 0, -1, dtype=float)
    else:
        nlive_per_it = np.asarray(nlive, dtype=float)
        if len(nlive_per_it) != n:
            raise ValueError("nlive and samples are different lengths")
    log_t = -1.0 / nlive_per_it
    log_vols = np.zeros(n + 2)
    log_vols[1:-1] = np.cumsum(log_t)
    log_vols[-1] = -np.inf
    log_likelihoods = np.concatenate([[-np.inf], samples, [samples[-1]]])
    log_z = log_integrate_log_trap(log_likelihoods, log_vols)
    log_w = logsubexp(log_vols[:-1], log_vols[1:])
    return float(log_z), log_likelihoods[1:-1] + log_w[:-1] - log_z


def draw_posterior_samples(nested_samples, nlive, rng=None):
    """Draw posterior samples from nested samples by rejection sampling."""
    if rng is None:
        rng = np.random.default_rng()
    _, log_w = compute_weights(nested_samples["logL"], nlive)
    log_u = np.log(rng.random(len(log_w)))
    return nested_samples[np.flatnonzero(log_w - np.max(log_w) > log_u)]
