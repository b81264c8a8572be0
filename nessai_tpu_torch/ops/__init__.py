"""Kernels of the port and their plain PyTorch versions.
Counterpart of ``nessai_tpu/ops``."""

from .coupling import affine_coupling, affine_coupling_plain

__all__ = ["affine_coupling", "affine_coupling_plain"]
