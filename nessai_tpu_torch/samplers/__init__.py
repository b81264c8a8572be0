"""Samplers. Counterpart of ``nessai_tpu/samplers``."""

from .base import BaseNestedSampler
from .importancesampler import ImportanceNestedSampler
from .nestedsampler import NestedSampler

__all__ = ["BaseNestedSampler", "ImportanceNestedSampler", "NestedSampler"]
