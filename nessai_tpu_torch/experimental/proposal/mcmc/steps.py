"""Ensemble MCMC steps in the flow's latent space. Counterpart of
``nessai_tpu/experimental/proposal/mcmc/steps.py``: the Gaussian step
with dynesty-style scale adaptation, the differential-evolution step
(emcee-style) and the Goodman-Weare stretch move, each vectorised over
the walkers and returning the log proposal ratio for the
Metropolis-Hastings acceptance. They run in numpy on the host generator,
drawing the JAX package's numbers in its order.

Calling convention: ``Step(dims, ensemble=..., rng=...)``, ``propose(z)``
(also ``step(z)`` and ``__call__``), ``update_ensemble`` and
``update_stats(n_accept, n_reject)``.
"""

import numpy as np

__all__ = [
    "Step",
    "MCMCStep",
    "GaussianStep",
    "DifferentialEvolutionStep",
    "StretchStep",
    "KNOWN_STEPS",
]


class MCMCStep:
    """Base step: propose new walker positions given the ensemble."""

    requires_ensemble = False

    def __init__(self, dims: int, ensemble=None, rng=None):
        self.dims = dims
        self.rng = rng if rng is not None else np.random.default_rng()
        self.update_ensemble(ensemble)
        self.n_accept = 0
        self.n_reject = 0

    def propose(self, z: np.ndarray):
        """``(z_new, log_ratio)``, ``log_ratio`` the log of the proposal's
        asymmetry."""
        raise NotImplementedError

    def step(self, z: np.ndarray):
        return self.propose(z)

    def __call__(self, *args, **kwargs):
        return self.step(*args, **kwargs)

    def update_ensemble(self, ensemble) -> None:
        self.ensemble = ensemble

    def update(self, acceptance: float) -> None:
        """Adapt the step's scales from the acceptance rate."""

    def update_stats(self, n_accept: int, n_reject: int) -> None:
        """Record the counts and adapt."""
        self.n_accept = n_accept
        self.n_reject = n_reject
        total = n_accept + n_reject
        if total:
            self.update(n_accept / total)


#: the base class by its name in nessai
Step = MCMCStep


class GaussianStep(MCMCStep):
    """Isotropic Gaussian random walk whose scale moves towards the
    target acceptance (dynesty-style); ``sigma`` is an alias of
    ``scale``."""

    def __init__(
        self,
        dims: int,
        ensemble=None,
        rng=None,
        scale: float = None,
        sigma: float = None,
        update_scale: bool = True,
        target_acceptance: float = 0.234,
    ):
        super().__init__(dims, ensemble=ensemble, rng=rng)
        if scale is None:
            scale = sigma if sigma is not None else 1.0
        self.sigma = float(scale)
        self.update_scale = update_scale
        self.target_acceptance = target_acceptance

    @property
    def scale(self) -> float:
        return self.sigma

    @scale.setter
    def scale(self, value) -> None:
        self.sigma = float(value)

    def propose(self, z: np.ndarray):
        z_new = z + self.sigma * self.rng.standard_normal(z.shape)
        return z_new, np.zeros(len(z))

    def update(self, acceptance: float) -> None:
        if self.update_scale:
            self.sigma *= np.exp((acceptance - self.target_acceptance) / self.dims)


class DifferentialEvolutionStep(MCMCStep):
    """Differential-evolution move ``z' = z + g (z_a - z_b)``, with
    ``g = 1`` (mode hopping) for a share ``mix_fraction`` of the walkers
    and ``g0 (1 + sigma N(0, 1))`` for the others."""

    requires_ensemble = True

    def __init__(
        self,
        dims: int,
        ensemble=None,
        g0: float = None,
        mix_fraction: float = 0.5,
        sigma: float = 1e-4,
        rng=None,
    ):
        super().__init__(dims, ensemble=ensemble, rng=rng)
        self.g0 = g0 if g0 is not None else 2.38 / np.sqrt(2 * dims)
        self.mix_fraction = mix_fraction
        self.sigma = sigma

    def propose(self, z: np.ndarray):
        n = len(z)
        # partners from the complementary ensemble where it is set, else
        # from the walkers themselves
        pool = self.ensemble if self.ensemble is not None else z
        m = len(pool)
        a = self.rng.integers(0, m, n)
        b = self.rng.integers(0, m, n)
        b = np.where(a == b, (b + 1) % m, b)
        mix = self.rng.random(n) < self.mix_fraction
        g = np.where(mix, 1.0, self.g0 * (1 + self.sigma * self.rng.standard_normal(n)))
        z_new = z + g[:, None] * (pool[a] - pool[b])
        return z_new, np.zeros(n)


class StretchStep(MCMCStep):
    """Goodman-Weare stretch move with stretch parameter ``scale`` (alias
    ``a``)."""

    requires_ensemble = True

    def __init__(self, dims: int, ensemble=None, scale: float = None, a: float = None, rng=None):
        super().__init__(dims, ensemble=ensemble, rng=rng)
        if scale is None:
            scale = a if a is not None else 2.0
        self.a = float(scale)

    @property
    def scale(self) -> float:
        return self.a

    @scale.setter
    def scale(self, value) -> None:
        self.a = float(value)

    def propose(self, z: np.ndarray):
        n = len(z)
        pool = self.ensemble if self.ensemble is not None else z
        m = len(pool)
        other = self.rng.integers(0, m, n)
        if self.ensemble is None:
            other = np.where(other == np.arange(n) % m, (other + 1) % m, other)
        u = self.rng.random(n)
        # the stretch factor, with density proportional to 1/sqrt(s) on [1/a, a]
        s = ((self.a - 1.0) * u + 1.0) ** 2 / self.a
        z_new = pool[other] + s[:, None] * (z - pool[other])
        log_ratio = (self.dims - 1) * np.log(s)
        return z_new, log_ratio


KNOWN_STEPS = {
    "gaussian": GaussianStep,
    "diff": DifferentialEvolutionStep,
    "differential_evolution": DifferentialEvolutionStep,
    "stretch": StretchStep,
}
