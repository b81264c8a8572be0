"""The device rule of the port: the GPU unless the caller asks for the
CPU, and never a silent fall-back."""

import torch

__all__ = ["get_device"]


def get_device(device=None) -> torch.device:
    """Resolve ``device`` (``None`` means ``"cuda"``).

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is available.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nessai_tpu_torch runs on a CUDA GPU by default, but no GPU "
            "is available (torch.cuda.is_available() is False). Pass "
            "device='cpu' to run the plain PyTorch path on the CPU."
        )
    return device
