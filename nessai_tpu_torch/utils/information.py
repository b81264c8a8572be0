"""Information/entropy helpers. Counterpart of
``nessai_tpu/utils/information.py``."""

import numpy as np

__all__ = ["differential_entropy"]


def differential_entropy(log_p: np.ndarray) -> float:
    """Monte-Carlo differential entropy estimate ``-mean(log p)``."""
    return float(-np.mean(np.asarray(log_p, dtype=float)))
