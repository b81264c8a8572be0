"""Latent-space sampling helpers. Counterpart of
``nessai_tpu/utils/sampling.py``; the truncated Gaussian is drawn on the
host with numpy, exactly as the JAX package's rounds populate does."""

import numpy as np
from scipy import stats
from scipy.special import gammainc, gammaincinv

__all__ = [
    "compute_radius",
    "draw_surface_nsphere",
    "NDimensionalTruncatedGaussian",
]


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


class NDimensionalTruncatedGaussian:
    """Exact sampler for an n-dim standard Gaussian truncated at
    ``radius``: inverse-CDF sampling of the radial chi distribution
    (``gammaincinv``) times a uniform direction."""

    def __init__(self, dims: int, radius: float, rng=None):
        self.dims = int(dims)
        self.radius = float(radius)
        self.rng = rng if rng is not None else np.random.default_rng()
        self.u_max = gammainc(self.dims / 2.0, self.radius**2 / 2.0)

    def sample(self, N: int) -> np.ndarray:
        u = self.rng.uniform(0, self.u_max, int(N))
        r = np.sqrt(2.0 * gammaincinv(self.dims / 2.0, u))
        x = draw_surface_nsphere(self.dims, r=1.0, N=N, rng=self.rng)
        return r[:, None] * x
