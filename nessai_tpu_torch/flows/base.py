"""Flow container: a bijector chain and a base distribution.
Counterpart of ``nessai_tpu/flows/base.py``.

Every pass takes an optional ``context`` (``[n, context_features]``),
which reaches the couplings' conditioner nets; the base distribution is
unconditional (``nessai_tpu/flows/base.py:43-114``)."""

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

    def forward(self, x, context=None):
        """x -> (z, log|dz/dx|)."""
        return self.bijector(x, context)

    def inverse(self, z, context=None):
        """z -> (x, log|dx/dz|)."""
        return self.bijector.inverse(z, context)

    def log_prob(self, x, context=None):
        z, log_j = self.bijector(x, context)
        return self.base.log_prob(z) + log_j

    def forward_and_log_prob(self, x, context=None):
        z, log_j = self.bijector(x, context)
        return z, self.base.log_prob(z) + log_j

    def inverse_and_log_prob(self, z, context=None):
        """z -> (x, log q(x)): the inverse pass with the base log-density
        and the Jacobian correction."""
        x, log_j = self.bijector.inverse(z, context)
        return x, self.base.log_prob(z) - log_j

    def base_log_prob(self, z):
        return self.base.log_prob(z)

    def base_distribution_log_prob(self, z, context=None):
        """An alias of :meth:`base_log_prob`; ``context`` is taken for the
        JAX package's signature (the bases are unconditional)."""
        return self.base_log_prob(z)

    def loss(self, x, weights=None, context=None):
        """The negative mean log-density of ``x``, or with ``weights``
        ``-sum(w log p) / sum(w)``."""
        log_p = self.log_prob(x, context)
        if weights is None:
            return -log_p.mean()
        return -(weights * log_p).sum() / weights.sum()

    # the JAX package's ``nessai_tpu/flows/base.py:73-105``
    def end_iteration(self, generator=None) -> None:
        """After each training epoch: a LARS base moves its normalisation
        estimate (:meth:`ResampledGaussian.update_log_z`); other bases
        have none."""
        if hasattr(self.base, "update_log_z"):
            self.base.update_log_z(generator=generator)

    def finalise(self, generator=None) -> None:
        """After training: a LARS base's final estimate of its
        normalisation (:meth:`ResampledGaussian.finalise`)."""
        if hasattr(self.base, "finalise"):
            self.base.finalise(generator=generator)

    def sample_base(self, n: int, generator=None):
        """``n`` latent draws from the base distribution."""
        return self.base.sample(n, generator)

    def sample(self, n: int, generator=None, context=None):
        """``n`` draws from the flow: base draws through the inverse."""
        return self.bijector.inverse(self.sample_base(n, generator), context)[0]

    def sample_and_log_prob(self, n: int, generator=None, context=None):
        """``n`` draws from the flow and their log-density."""
        return self.inverse_and_log_prob(self.sample_base(n, generator), context)
