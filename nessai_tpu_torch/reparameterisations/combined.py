"""Ordered application of several reparameterisations. Counterpart of
``nessai_tpu/reparameterisations/combined.py``."""

import logging

from ..utils.sorting import sort_reparameterisations
from .base import Reparameterisation

logger = logging.getLogger(__name__)

__all__ = ["CombinedReparameterisation"]


class CombinedReparameterisation(dict):
    """Reparameterisations keyed by name, applied in dependency order:
    forward in insertion (topological) order, inverse in the reverse
    order; ``reverse_order`` swaps the two."""

    def __init__(self, reparameterisations=None, reverse_order: bool = False, initial_parameters=None):
        super().__init__()
        self.reverse_order = reverse_order
        self.parameters = []
        self.prime_parameters = []
        #: parameters available before any reparameterisation runs, so
        #: chained stages may consume model parameters no stage produces
        self.initial_parameters = list(initial_parameters) if initial_parameters is not None else []
        #: name of the member whose missing device inverse made the last
        #: :meth:`torch_inverse` return None
        self.no_torch_inverse = None
        if reparameterisations is not None:
            self.add_reparameterisations(reparameterisations)

    @property
    def has_prime_prior(self) -> bool:
        return all(r.has_prime_prior for r in self.values())

    @property
    def auxiliary_parameters(self):
        out = []
        for r in self.values():
            out += list(getattr(r, "auxiliary_parameters", []))
        return out

    @property
    def one_to_one(self) -> bool:
        return all(r.one_to_one for r in self.values())

    def _order(self):
        order = list(self.values())
        return list(reversed(order)) if self.reverse_order else order

    @property
    def to_prime_order(self):
        """Application order to the prime space."""
        return [r.name for r in self._order()]

    @property
    def from_prime_order(self):
        """Application order from the prime space."""
        return [r.name for r in reversed(self._order())]

    def add_reparameterisation(self, reparameterisation):
        self.add_reparameterisations(reparameterisation)

    def add_reparameterisations(self, reparameterisations):
        if isinstance(reparameterisations, Reparameterisation):
            reparameterisations = [reparameterisations]
        ordered = sort_reparameterisations(
            list(reparameterisations),
            existing_parameters=self.initial_parameters + self.parameters,
            existing_prime_parameters=self.prime_parameters,
        )
        for r in ordered:
            self[r.name] = r
            self.parameters += [p for p in r.parameters if p not in self.parameters]
            self.prime_parameters += [p for p in r.prime_parameters if p not in self.prime_parameters]
        self.check_order()

    def check_order(self) -> None:
        """Verify every reparameterisation's requirements are met by the
        time it runs."""
        produced = list(self.initial_parameters) + list(self.parameters) + list(self.prime_parameters)
        for r in self._order():
            missing = [q for q in (r.requires or []) if q not in produced]
            if missing:
                raise RuntimeError(f"{r.name} requires {missing} which are not available")

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        for r in self._order():
            x, x_prime, log_j = r.reparameterise(x, x_prime, log_j, **kwargs)
        return x, x_prime, log_j

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for r in reversed(self._order()):
            x, x_prime, log_j = r.inverse_reparameterise(x, x_prime, log_j, **kwargs)
        return x, x_prime, log_j

    def torch_inverse(self, cols: dict):
        """Compose the members' device inverses in :attr:`from_prime_order`,
        as :meth:`inverse_reparameterise` does on the host. Returns
        ``(cols, log_j)`` with every column, prime and x-space, or None
        (naming the member in :attr:`no_torch_inverse`) if a member has
        no device inverse."""
        log_j = 0.0
        for r in reversed(self._order()):
            out = r.torch_inverse(cols)
            if out is None:
                self.no_torch_inverse = r.name
                return None
            updates, lj = out
            cols = {**cols, **updates}
            log_j = log_j + lj
        return cols, log_j

    @property
    def has_torch_inverse(self) -> bool:
        """Whether every member inverts on the device (the first that does
        not is named in :attr:`no_torch_inverse`)."""
        for r in self.values():
            if not r.has_torch_inverse:
                self.no_torch_inverse = r.name
                return False
        return True

    def torch_log_prior_fn(self):
        """The members' auxiliary priors on the device, summed (a
        function of the x-space columns), or None if a member with a prior
        has no device form; members without priors add nothing, as in
        :meth:`log_prior`."""
        parts = []
        for r in self.values():
            if getattr(r, "has_prior", False):
                fn = r.torch_log_prior_fn()
                if fn is None:
                    return None
                parts.append(fn)

        def log_prior(cols):
            log_p = 0.0
            for fn in parts:
                log_p = log_p + fn(cols)
            return log_p

        return log_prior

    def update(self, x) -> None:
        for r in self.values():
            r.update(x)

    update_bounds = update

    def reset(self) -> None:
        for r in self.values():
            r.reset()

    def reset_inversion(self) -> None:
        """Reset any boundary-inversion state."""
        for r in self.values():
            if hasattr(r, "reset_inversion"):
                r.reset_inversion()

    def log_prior(self, x):
        """Sum of the members' auxiliary-parameter priors."""
        log_p = 0.0
        for r in self.values():
            if getattr(r, "has_prior", False):
                log_p = log_p + r.log_prior(x)
        return log_p

    def x_prime_log_prior(self, x_prime):
        log_p = 0.0
        for r in self.values():
            log_p = log_p + r.x_prime_log_prior(x_prime)
        return log_p
