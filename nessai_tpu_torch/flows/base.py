"""Flow container: a bijector chain and a base distribution.
Counterpart of ``nessai_tpu/flows/base.py``."""

from torch import nn

__all__ = ["Flow"]


class Flow(nn.Module):
    """A normalising flow: ``base`` distribution in latent space plus a
    bijector mapping data to latent."""

    def __init__(self, bijector, base, dim: int):
        super().__init__()
        self.bijector = bijector
        self.base = base
        self.dim = dim

    def forward(self, x):
        """x -> (z, log|dz/dx|)."""
        return self.bijector(x)

    def inverse(self, z):
        """z -> (x, log|dx/dz|)."""
        return self.bijector.inverse(z)

    def log_prob(self, x):
        z, log_j = self.bijector(x)
        return self.base.log_prob(z) + log_j

    def forward_and_log_prob(self, x):
        z, log_j = self.bijector(x)
        return z, self.base.log_prob(z) + log_j

    def inverse_and_log_prob(self, z):
        """z -> (x, log q(x)): the inverse pass with the base log-density
        and the Jacobian correction."""
        x, log_j = self.bijector.inverse(z)
        return x, self.base.log_prob(z) - log_j

    def base_log_prob(self, z):
        return self.base.log_prob(z)
