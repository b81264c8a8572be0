"""Ordered application of several reparameterisations. Counterpart of
``nessai_tpu/reparameterisations/combined.py``."""

from .base import Reparameterisation

__all__ = ["CombinedReparameterisation"]


class CombinedReparameterisation(dict):
    """Reparameterisations keyed by name, applied in insertion order
    (forward) and in reverse order (inverse)."""

    def __init__(self, reparameterisations=None):
        super().__init__()
        self.parameters = []
        self.prime_parameters = []
        if reparameterisations is not None:
            self.add_reparameterisations(reparameterisations)

    @property
    def has_prime_prior(self) -> bool:
        return all(r.has_prime_prior for r in self.values())

    @property
    def one_to_one(self) -> bool:
        return all(r.one_to_one for r in self.values())

    def add_reparameterisation(self, reparameterisation):
        self.add_reparameterisations([reparameterisation])

    def add_reparameterisations(self, reparameterisations):
        if isinstance(reparameterisations, Reparameterisation):
            reparameterisations = [reparameterisations]
        for r in reparameterisations:
            self[r.name] = r
            self.parameters += [p for p in r.parameters if p not in self.parameters]
            self.prime_parameters += [
                p for p in r.prime_parameters if p not in self.prime_parameters
            ]

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        for r in self.values():
            x, x_prime, log_j = r.reparameterise(x, x_prime, log_j, **kwargs)
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for r in reversed(list(self.values())):
            x, x_prime, log_j = r.inverse_reparameterise(x, x_prime, log_j, **kwargs)
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """Compose the children's device inverses in the order of
        :meth:`inverse_reparameterise`."""
        log_j = 0.0
        for r in reversed(list(self.values())):
            updates, lj = r.torch_inverse(cols)
            cols = {**cols, **updates}
            log_j = log_j + lj
        return cols, log_j

    def update(self, x) -> None:
        for r in self.values():
            r.update(x)

    def reset(self) -> None:
        for r in self.values():
            r.reset()

    def log_prior(self, x):
        log_p = 0.0
        for r in self.values():
            if r.has_prior:
                log_p = log_p + r.log_prior(x)
        return log_p
