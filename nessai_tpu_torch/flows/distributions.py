"""Base (latent) distributions. Counterpart of
``nessai_tpu/flows/distributions.py:25-186``: the unit Gaussian, a
Gaussian of scalar variance, the uniform box and the learnt-acceptance
resampled Gaussian (LARS).

Each is an ``nn.Module`` with ``log_prob(z)`` and ``sample(n,
generator)``; draws come from the ``torch.Generator`` given, on its
device, or from the default generator on the distribution's device.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from .nets import MLP

__all__ = ["StandardNormal", "MultivariateNormal", "MultivariateUniform", "ResampledGaussian"]


class _Base(nn.Module):
    """A distribution on ``dim`` dimensions that knows its device (a
    buffer left out of the state dict)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = int(dim)
        self.register_buffer("_anchor", torch.zeros(()), persistent=False)

    def _device(self, generator=None):
        return self._anchor.device if generator is None else generator.device

    def _normal(self, n: int, generator=None):
        """``[n, dim]`` float32 standard normals: one ``torch.randn`` call."""
        return torch.randn(int(n), self.dim, generator=generator, device=self._device(generator))


class StandardNormal(_Base):
    """Unit Gaussian base distribution."""

    def log_prob(self, z):
        return -0.5 * torch.sum(z**2, dim=-1) - 0.5 * self.dim * math.log(2 * math.pi)

    def sample(self, n: int, generator=None):
        return self._normal(n, generator)


class MultivariateNormal(StandardNormal):
    """Zero-mean Gaussian with scalar variance ``var``
    (``nessai_tpu/flows/distributions.py:43-72``); ``shape`` is the
    reference's one-tuple of the dimension."""

    def __init__(self, dim: int = None, var: float = 1.0, shape=None):
        if shape is not None:
            if dim is not None:
                raise ValueError("Specify either dim or shape, not both")
            dim = int(math.prod(shape))
        if dim is None:
            raise ValueError("Must specify dim or shape")
        super().__init__(dim)
        self.var = float(var)

    def log_prob(self, z):
        return -0.5 * torch.sum(z**2, dim=-1) / self.var - 0.5 * self.dim * (
            math.log(2 * math.pi) + math.log(self.var)
        )

    def sample(self, n: int, generator=None):
        return math.sqrt(self.var) * self._normal(n, generator)


class MultivariateUniform(_Base):
    """Uniform on ``[low, high]^dim``, -inf outside
    (``nessai_tpu/flows/distributions.py:75-94``): the base of flows on
    the unit hypercube."""

    def __init__(self, dim: int, low: float = 0.0, high: float = 1.0):
        super().__init__(dim)
        self.low = float(low)
        self.high = float(high)

    def log_prob(self, z):
        inside = torch.all((z >= self.low) & (z <= self.high), dim=-1)
        lp = torch.full(inside.shape, -self.dim * math.log(self.high - self.low), dtype=z.dtype, device=z.device)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def sample(self, n: int, generator=None):
        u = torch.rand(int(n), self.dim, generator=generator, device=self._device(generator))
        return self.low + (self.high - self.low) * u


class ResampledGaussian(_Base):
    """Learnt-acceptance resampled Gaussian (LARS, arXiv:2110.15828;
    ``nessai_tpu/flows/distributions.py:97-186``).

    ``log_prob(z) = log N(z) + log((1 - eps) a(z) / Z + eps)`` with the
    acceptance ``a`` a sigmoid of a tanh MLP and ``Z = E_N[a]`` kept as
    the parameter ``log_Z``: trained with the flow, as in the JAX package,
    and moved towards a Monte Carlo estimate by :meth:`update_log_z`
    after every epoch and replaced by :meth:`finalise`'s after training.
    """

    def __init__(
        self,
        dim: int,
        n_neurons: int = 128,
        n_layers: int = 2,
        eps: float = 0.05,
        T: int = 100,
        trainable: bool = True,
        generator=None,
    ):
        super().__init__(dim)
        self.n_neurons = n_neurons
        self.n_layers = n_layers
        self.eps = float(eps)
        self.T = int(T)
        # a zero last layer: a(z) = 1/2 everywhere, so Z = 1/2
        self.net = MLP(dim, 1, n_neurons, n_layers, activation="tanh", generator=generator)
        self.log_Z = nn.Parameter(torch.tensor(math.log(0.5)))

    def _log_accept(self, z):
        return F.logsigmoid(self.net(z)[..., 0])

    def log_prob(self, z):
        base = -0.5 * torch.sum(z**2, dim=-1) - 0.5 * self.dim * math.log(2 * math.pi)
        a_over_z = torch.exp(self._log_accept(z) - self.log_Z)
        return base + torch.log((1.0 - self.eps) * a_over_z + self.eps)

    @torch.no_grad()
    def estimate_log_z(self, n: int = 10000, generator=None, z=None):
        """``log mean a(z)`` over ``n`` standard normals (or the draws
        ``z``)."""
        if z is None:
            z = self._normal(n, generator)
        log_a = self._log_accept(z)
        return torch.logsumexp(log_a, dim=0) - math.log(len(z))

    @torch.no_grad()
    def update_log_z(self, n: int = 10000, decay: float = 0.99, generator=None, z=None) -> None:
        """Move ``log_Z`` to ``log(decay Z + (1 - decay) Z_new)`` with
        ``Z_new`` the estimate over ``n`` draws (or ``z``); ``decay = 0``
        replaces it."""
        new = self.estimate_log_z(n, generator, z)
        log_decay = math.log(decay) if decay > 0 else -math.inf
        log_rest = math.log(1 - decay) if decay < 1 else -math.inf
        self.log_Z.copy_(torch.logaddexp(log_decay + self.log_Z, log_rest + new))

    def finalise(self, n_samples: int = 10_000, n_batches: int = 10, generator=None) -> None:
        """A final estimate of ``log_Z`` from ``n_samples * n_batches``
        draws, replacing the running one."""
        self.update_log_z(n_samples * n_batches, decay=0.0, generator=generator)

    @torch.no_grad()
    def sample(self, n: int, generator=None):
        """Truncated rejection resampling: each of ``n`` rows takes the
        first of ``T`` standard-normal proposals that ``a`` accepts, and
        the last one where none does."""
        n = int(n)
        out = torch.zeros(n, self.dim, device=self._device(generator))
        accepted = torch.zeros(n, dtype=torch.bool, device=out.device)
        for i in range(self.T):
            z = self._normal(n, generator)
            log_a = self._log_accept(z)
            u = torch.rand(n, generator=generator, device=out.device)
            take = ((torch.log(u) < log_a) & ~accepted) | (~accepted if i == self.T - 1 else False)
            out = torch.where(take[:, None], z, out)
            accepted = accepted | take
            if bool(accepted.all()):
                break
        return out
