"""Samplers. Counterpart of ``nessai_tpu/samplers``."""

from .base import BaseNestedSampler
from .nestedsampler import NestedSampler

__all__ = ["BaseNestedSampler", "NestedSampler"]
