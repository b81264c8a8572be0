"""The nested-sampling evidence recursion, written out plainly.

Skilling's rectangle rule with the expected log-shrinkage ``<log t> =
-1/n`` per dead point at ``n`` live points: the log prior volume after
dead point ``i`` is ``log X_i = -sum_{j<=i} 1/n_j``, its weight
``w_i = X_{i-1} (1 - e^{-1/n_i})`` and ``log Z = logsumexp(log L_i +
log w_i)``. A finished run closes with the trapezoid rule over
``(log X, log L)`` and a last point at ``X = 0`` and the largest ``L``.

``dtype`` is float64 for the reference and float32 for the control.
"""

import numpy as np

__all__ = ["log_volumes", "log_evidence", "log_evidence_trapezoid"]


def log_volumes(nlives, dtype=np.float64):
    """``log X_i`` after each dead point, for the live counts ``nlives``."""
    shrink = (-1.0 / np.asarray(nlives, dtype=np.float64)).astype(dtype)
    return np.cumsum(shrink, dtype=dtype)


def _logsumexp(a, dtype):
    a = np.asarray(a, dtype=dtype)
    m = np.max(a)
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(a - m, dtype=dtype), dtype=dtype), dtype=dtype)


def log_evidence(logL, nlives, dtype=np.float64):
    """The rectangle rule's log-evidence of the dead points ``logL``."""
    logL = np.asarray(logL, dtype=np.float64).astype(dtype)
    nlives = np.asarray(nlives, dtype=np.float64)
    log_x = log_volumes(nlives, dtype)
    log_x_prev = np.concatenate([np.zeros(1, dtype), log_x[:-1]]).astype(dtype)
    log_shrink = np.log(-np.expm1(-1.0 / nlives)).astype(dtype)
    return float(_logsumexp(logL + log_x_prev + log_shrink, dtype))


def log_evidence_trapezoid(logL, nlives, dtype=np.float64):
    """The trapezoid rule over the dead points of a finished run, from
    ``X = 1`` at ``L = 0`` to ``X = 0`` at the largest ``L``."""
    logL = np.concatenate([[-np.inf], np.asarray(logL, np.float64), [np.max(logL)]]).astype(dtype)
    log_x = np.concatenate([[0.0], log_volumes(nlives, np.float64), [-np.inf]]).astype(dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        # log((X_{i-1} - X_i) (L_{i-1} + L_i) / 2), term by term
        log_dx = log_x[:-1] + np.log(-np.expm1(log_x[1:] - log_x[:-1])).astype(dtype)
        log_l = np.logaddexp(logL[:-1], logL[1:]).astype(dtype) - dtype(np.log(2.0))
    return float(_logsumexp(log_dx + log_l, dtype))
