"""Histogram bin selection. Counterpart of ``nessai_tpu/utils/hist.py``."""

import numpy as np

__all__ = ["auto_bins"]


def _sturges(x: np.ndarray) -> int:
    return int(np.ceil(np.log2(x.size)) + 1)


def _fd(x: np.ndarray) -> int:
    iqr = np.subtract(*np.percentile(x, [75, 25]))
    if iqr <= 0:
        return 1
    h = 2.0 * iqr * x.size ** (-1.0 / 3.0)
    if h <= 0:
        return 1
    return int(np.ceil((x.max() - x.min()) / h))


def auto_bins(x, max_bins: int = 50) -> int:
    """Freedman-Diaconis/Sturges automatic bin count, capped at
    ``max_bins``."""
    x = np.asarray(x).ravel()
    if not x.size:
        raise RuntimeError("Input array is empty!")
    if x.size == 1:
        return 1
    return max(min(max(_fd(x), _sturges(x)), max_bins), 1)
