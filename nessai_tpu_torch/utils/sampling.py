"""Latent-space sampling helpers. Counterpart of
``nessai_tpu/utils/sampling.py``; the truncated Gaussian is drawn on the
host with numpy, exactly as the JAX package's rounds populate does.
:func:`_bucket_size` is the JAX package's rounding of a batch size to a
power of two (``nessai_tpu/flowmodel/base.py:69-79``), which fixes the
device populate loop's batch and the prior populate's pool size."""

import numpy as np
from scipy import stats
from scipy.special import gammainc, gammaincinv

__all__ = [
    "_bucket_size",
    "compute_radius",
    "draw_surface_nsphere",
    "draw_nsphere",
    "draw_uniform",
    "draw_gaussian",
    "draw_truncated_gaussian",
    "NDimensionalTruncatedGaussian",
]


def _bucket_size(n: int, minimum: int = 256) -> int:
    """``n`` rounded up to a power of two, and at least ``minimum``.

    This sets semantics, not padding: the device populate loop draws
    batches of ``_bucket_size(drawsize or 4 * poolsize)`` and normalises
    each by its own largest weight, and the prior populate fills a pool
    of ``_bucket_size(N)`` draws, every one of which the sampler
    consumes."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def compute_radius(n: int, q: float = 0.95) -> float:
    """Radius containing fraction ``q`` of an n-dim standard Gaussian."""
    return float(stats.chi.ppf(q, n))


def draw_surface_nsphere(dims, r=1.0, N=1000, rng=None):
    """Uniform points on the surface of an n-sphere (Marsaglia)."""
    if rng is None:
        rng = np.random.default_rng()
    x = rng.standard_normal((int(N), dims))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return r * x


def draw_nsphere(dims, r=1.0, N=1000, fuzz=1.0, rng=None):
    """Uniform points inside an n-ball of radius ``r * fuzz``."""
    if rng is None:
        rng = np.random.default_rng()
    x = draw_surface_nsphere(dims, r=1.0, N=N, rng=rng)
    u = rng.uniform(0, 1, (int(N), 1)) ** (1.0 / dims)
    return r * fuzz * u * x


def draw_uniform(dims, r=1.0, N=1000, fuzz=1.0, rng=None):
    """Uniform points in the unit hypercube (``r`` and ``fuzz`` are
    unused, kept for a common signature)."""
    if rng is None:
        rng = np.random.default_rng()
    return rng.uniform(0, 1, (int(N), dims))


def draw_gaussian(dims, r=1.0, N=1000, fuzz=1.0, rng=None, temperature=1):
    """Standard Gaussian draws scaled by ``sqrt(temperature)``."""
    if rng is None:
        rng = np.random.default_rng()
    return np.sqrt(temperature) * rng.standard_normal((int(N), dims))


def draw_truncated_gaussian(dims, r, N=1000, fuzz=1.0, var=1.0, rng=None):
    """Gaussian draws of variance ``var`` truncated to the radius
    ``r * fuzz``, by rejection."""
    if rng is None:
        rng = np.random.default_rng()
    sigma = np.sqrt(var)
    r_max = r * fuzz
    out = np.empty((0, dims))
    n_target = int(N)
    while out.shape[0] < n_target:
        x = sigma * rng.standard_normal((n_target, dims))
        keep = np.linalg.norm(x, axis=1) < r_max
        out = np.concatenate([out, x[keep]], axis=0)
    return out[:n_target]


class NDimensionalTruncatedGaussian:
    """Exact sampler for an n-dim standard Gaussian truncated at
    ``radius * fuzz``: inverse-CDF sampling of the radial chi
    distribution (``gammaincinv``) times a uniform direction."""

    def __init__(self, dims: int, radius: float, fuzz: float = 1.0, rng=None):
        self.dims = int(dims)
        self.radius = float(radius)
        self.fuzz = float(fuzz)
        self.rng = rng if rng is not None else np.random.default_rng()
        r = self.radius * self.fuzz
        self.u_max = gammainc(self.dims / 2.0, r**2 / 2.0)

    def sample(self, N: int) -> np.ndarray:
        u = self.rng.uniform(0, self.u_max, int(N))
        r = np.sqrt(2.0 * gammaincinv(self.dims / 2.0, u))
        x = draw_surface_nsphere(self.dims, r=1.0, N=N, rng=self.rng)
        return r[:, None] * x
