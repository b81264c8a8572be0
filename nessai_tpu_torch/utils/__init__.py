"""Utilities. Counterpart of ``nessai_tpu/utils``."""

from .device import get_device
from .hist import auto_bins
from .indices import bonferroni_correction, compute_indices_ks_test
from .information import differential_entropy
from .logging import configure_logger
from .rescaling import (
    inverse_rescale_minus_one_to_one,
    inverse_rescale_zero_to_one,
    logit,
    rescale_minus_one_to_one,
    rescale_zero_to_one,
    sigmoid,
)
from .sampling import compute_radius, draw_nsphere, draw_truncated_gaussian
from .stats import effective_sample_size, rolling_mean, weighted_quantile
from .structures import (
    array_split_chunksize,
    get_inverse_indices,
    get_subset_arrays,
    isfinite_struct,
)

__all__ = [
    "auto_bins",
    "bonferroni_correction",
    "compute_indices_ks_test",
    "differential_entropy",
    "configure_logger",
    "get_device",
    "logit",
    "sigmoid",
    "rescale_zero_to_one",
    "rescale_minus_one_to_one",
    "inverse_rescale_zero_to_one",
    "inverse_rescale_minus_one_to_one",
    "compute_radius",
    "draw_nsphere",
    "draw_truncated_gaussian",
    "effective_sample_size",
    "rolling_mean",
    "weighted_quantile",
    "array_split_chunksize",
    "get_inverse_indices",
    "get_subset_arrays",
    "isfinite_struct",
]
