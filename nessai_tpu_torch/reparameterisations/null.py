"""Pass-through reparameterisation. Counterpart of
``nessai_tpu/reparameterisations/null.py``
(``IdentityReparameterisation``, with ``NullReparameterisation`` as an
alias)."""

from .base import Reparameterisation

__all__ = ["IdentityReparameterisation", "NullReparameterisation"]


class IdentityReparameterisation(Reparameterisation):
    """Identity: x' = x (prime parameters share the original names)."""

    def __init__(self, parameters=None, prior_bounds=None, rng=None, **kwargs):
        super().__init__(parameters=parameters, prior_bounds=prior_bounds, rng=rng, **kwargs)
        self.prime_parameters = list(self.parameters)

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            x_prime[pp] = x[p]
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            x[p] = x_prime[pp]
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        return {p: cols[pp] for p, pp in zip(self.parameters, self.prime_parameters)}, 0.0


NullReparameterisation = IdentityReparameterisation
