"""Latent truncation for the flow proposal's populate. Counterpart of
``nessai_tpu/proposal/flowproposal/truncation.py``'s ``latent_radius``
rule in its ``constant_volume`` mode, the flow proposal's default."""

import logging

import numpy as np

from ...utils.sampling import NDimensionalTruncatedGaussian, compute_radius

logger = logging.getLogger(__name__)

__all__ = ["LatentRadiusTruncation"]


class LatentRadiusTruncation:
    """Sample the latent Gaussian truncated to the ball of radius ``r``
    that holds ``q`` of its mass (the chi-PPF radius), exactly
    (inverse-CDF, no rejection)."""

    #: mass of the latent Gaussian inside the truncation ball
    q = 0.95

    def __init__(self, dims: int, rng):
        self.r = compute_radius(dims, self.q)
        self._dist = NDimensionalTruncatedGaussian(dims, self.r, rng=rng)
        logger.debug("Latent radius: %.3f", self.r)

    def sample_latent(self, n: int):
        return self._dist.sample(n)

    def apply_latent(self, z):
        return z[np.linalg.norm(z, axis=1) <= self.r]
