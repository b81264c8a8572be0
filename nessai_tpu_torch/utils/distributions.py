"""Simple latent distributions on the device. Counterpart of
``nessai_tpu/utils/distributions.py``: a uniform box and a zero-mean
Gaussian of scalar variance, with log-densities and samplers; the
samplers draw from an explicit ``torch.Generator`` where the JAX
versions take a key."""

import math

import torch

__all__ = [
    "get_uniform_distribution",
    "get_multivariate_normal",
    "BoxUniform",
    "DiagonalNormal",
]


class BoxUniform:
    """Uniform on ``[-r, r]^dims``."""

    def __init__(self, dims: int, r: float = 1.0, device=None):
        self.dims = dims
        self.r = float(r)
        self.device = torch.device("cpu" if device is None else device)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        inside = torch.all(torch.abs(z) <= self.r, dim=-1)
        lp = torch.full(inside.shape, -self.dims * math.log(2 * self.r), dtype=z.dtype, device=z.device)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """``n`` draws from ``generator`` (on its device)."""
        u = torch.rand(n, self.dims, generator=generator, device=generator.device)
        return (2.0 * u - 1.0) * self.r


class DiagonalNormal:
    """Zero-mean Gaussian with the scalar variance ``var``."""

    def __init__(self, dims: int, var: float = 1.0, device=None):
        self.dims = dims
        self.var = float(var)
        self.device = torch.device("cpu" if device is None else device)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(z**2, dim=-1) / self.var - 0.5 * self.dims * (
            math.log(2 * math.pi) + math.log(self.var)
        )

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """``n`` draws from ``generator`` (on its device)."""
        return math.sqrt(self.var) * torch.randn(n, self.dims, generator=generator, device=generator.device)


def get_uniform_distribution(dims: int, r: float, device=None) -> BoxUniform:
    """A :class:`BoxUniform` on ``[-r, r]^dims``."""
    return BoxUniform(dims, r, device=device)


def get_multivariate_normal(dims: int, var: float = 1.0, device=None) -> DiagonalNormal:
    """A :class:`DiagonalNormal` of variance ``var``."""
    return DiagonalNormal(dims, var, device=device)
