"""Kernels of the port and their plain PyTorch versions.
Counterpart of ``nessai_tpu/ops``."""

from .coupling import affine_coupling, affine_coupling_plain
from .rqs import rqs, rqs_plain

__all__ = ["affine_coupling", "affine_coupling_plain", "rqs", "rqs_plain"]
