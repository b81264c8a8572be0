"""Pass-through reparameterisation. Counterpart of
``nessai_tpu/reparameterisations/null.py``."""

from .base import Reparameterisation

__all__ = ["IdentityReparameterisation", "NullReparameterisation"]


class IdentityReparameterisation(Reparameterisation):
    """Identity: x' = x, with the prime parameters named like x."""

    def __init__(self, parameters=None, prior_bounds=None, rng=None):
        super().__init__(parameters, prior_bounds, rng, prime_parameters=parameters)

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
