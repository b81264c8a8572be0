"""Host thread count of the flows. Counterpart of
``nessai_tpu/utils/threading.py``: here the request maps onto
``torch.set_num_threads``."""

import logging

import torch

logger = logging.getLogger(__name__)

__all__ = ["configure_threads"]


def configure_threads(max_threads=None, pytorch_threads=None) -> None:
    """Set PyTorch's intra-op thread count to ``max_threads`` (or its
    older name ``pytorch_threads``); None leaves it as it is."""
    if max_threads is None:
        max_threads = pytorch_threads
    if max_threads is None:
        return
    logger.debug("Setting PyTorch threads to %s", max_threads)
    torch.set_num_threads(int(max_threads))
