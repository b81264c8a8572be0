"""Posterior samples from nested samples. Counterpart of
``nessai_tpu/posterior.py``."""

import numpy as np
from scipy.special import logsumexp

from .evidence import log_integrate_log_trap, logsubexp
from .utils.stats import effective_sample_size

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


def draw_posterior_samples(
    nested_samples, nlive=None, n=None, log_w=None, method="rejection_sampling", rng=None
):
    """Draw posterior samples from nested samples.

    The log-weights are ``log_w`` where given (the importance nested
    sampler's), else the nested-sampling weights for ``nlive``.
    ``"rejection_sampling"`` keeps each sample with probability
    ``w / max(w)``; ``"importance_sampling"`` (or its alias
    ``"multinomial_resampling"``) draws ``n`` samples with replacement
    in proportion to ``w`` (``n`` defaults to the effective sample
    size)."""
    if rng is None:
        rng = np.random.default_rng()
    if log_w is None:
        _, log_w = compute_weights(nested_samples["logL"], nlive)
    if method == "rejection_sampling":
        log_u = np.log(rng.random(len(log_w)))
        indices = np.flatnonzero(log_w - np.max(log_w) > log_u)
    elif method in ("importance_sampling", "multinomial_resampling"):
        if n is None:
            n = int(effective_sample_size(log_w))
        p = np.exp(log_w - logsumexp(log_w))
        indices = rng.choice(len(log_w), size=n, replace=True, p=p)
    else:
        raise ValueError(f"Unknown method: {method}")
    return nested_samples[indices]
