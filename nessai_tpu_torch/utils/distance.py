"""Nearest-neighbour distances for the adaptive training noise.
Counterpart of ``nessai_tpu/utils/distance.py``."""

import numpy as np

__all__ = ["compute_minimum_distances"]


def compute_minimum_distances(samples: np.ndarray, metric: str = "euclidean") -> np.ndarray:
    """The distance of each sample to its nearest other sample."""
    from scipy.spatial.distance import cdist

    d = cdist(samples, samples, metric)
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1)
