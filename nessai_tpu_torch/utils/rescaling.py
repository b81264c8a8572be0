"""The logit and sigmoid maps of the importance nested sampler's
proposal. Counterpart of ``logit`` and ``sigmoid`` in
``nessai_tpu/utils/rescaling.py`` (numpy, float64)."""

import numpy as np

from .. import config

__all__ = ["logit", "sigmoid"]


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
