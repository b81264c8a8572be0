"""Base (latent) distribution. Counterpart of
``nessai_tpu/flows/distributions.py`` (``StandardNormal``)."""

import math

import torch
from torch import nn

__all__ = ["StandardNormal"]


class StandardNormal(nn.Module):
    """Unit Gaussian base distribution."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def log_prob(self, z):
        return -0.5 * torch.sum(z**2, dim=-1) - 0.5 * self.dim * math.log(2 * math.pi)
