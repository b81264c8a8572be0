"""Utilities. Counterpart of ``nessai_tpu/utils``."""

from .device import get_device
from .logging import configure_logger

__all__ = ["configure_logger", "get_device"]
