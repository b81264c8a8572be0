"""Array-structure helpers. Counterpart of
``nessai_tpu/utils/structures.py`` (numpy only, copied as it is)."""

from typing import List, Sequence

import numpy as np

__all__ = [
    "get_subset_arrays",
    "isfinite_struct",
    "array_split_chunksize",
    "get_inverse_indices",
    "replace_in_list",
]


def get_subset_arrays(indices, *arrays):
    """Return each array indexed by ``indices``."""
    return tuple(a[indices] for a in arrays)


def isfinite_struct(x: np.ndarray, names: Sequence[str] = None) -> np.ndarray:
    """Elementwise all-finite check across fields of a structured array."""
    if names is None:
        names = x.dtype.names
    return np.all([np.isfinite(x[n]) for n in names], axis=0)


def array_split_chunksize(x: np.ndarray, chunksize: int) -> List[np.ndarray]:
    """Split an array into chunks of at most ``chunksize`` rows."""
    if chunksize < 1:
        raise ValueError("chunksize must be greater than 1")
    n = len(x)
    return [x[i : i + chunksize] for i in range(0, n, chunksize)]


def get_inverse_indices(n: int, indices: np.ndarray) -> np.ndarray:
    """Indices in ``range(n)`` not present in ``indices``.

    Raises ValueError if any index is out of range for ``n``.
    """
    indices = np.asarray(indices)
    if indices.size and indices.max() >= n:
        raise ValueError(
            "Indices contain values that are out of range for n"
        )
    mask = np.ones(n, dtype=bool)
    mask[indices] = False
    return np.flatnonzero(mask)


def replace_in_list(target_list, targets, replacements) -> None:
    """Replace entries of a list in place."""
    if not isinstance(targets, list):
        targets = [targets]
    if not isinstance(replacements, list):
        replacements = [replacements]
    if len(targets) != len(replacements):
        raise RuntimeError("Targets and replacements are different lengths!")
    if not all(t in target_list for t in targets):
        raise ValueError(f"Targets {targets} not in list: {target_list}")
    for t, r in zip(targets, replacements):
        target_list[target_list.index(t)] = r
