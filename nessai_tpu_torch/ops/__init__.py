"""Kernels of the port and their plain PyTorch versions.
Counterpart of ``nessai_tpu/ops``."""

from .coupling import affine_coupling, affine_coupling_plain
from .ns_scan import ns_scan, ns_scan_plain
from .rqs import rqs, rqs_plain

__all__ = ["affine_coupling", "affine_coupling_plain", "ns_scan", "ns_scan_plain", "rqs", "rqs_plain"]
