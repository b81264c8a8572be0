"""MCMC flow proposal: the pool is filled by ensemble MCMC in the flow's
latent space in place of rejection sampling. Counterpart of
``nessai_tpu/experimental/proposal/mcmc/proposal.py``.

All walkers step together: each step is one batched flow inverse on the
flow's device (K1 launches for a RealNVP on the GPU) and one batched
likelihood call. The steps draw from the proposal's host generator, so
the random stream is the JAX package's draw for draw.

The chain's target is the constrained prior carried to the latent space,
``p(x(z)) |dx/dz|``. The JAX package accepts by ``p(x) / q(x)`` instead,
which leaves out the base density ``q_z(z)`` (``q(x) = q_z(z) |dz/dx|``):
its chain then samples ``p(x) / q_z(z(x))``, which weights the flow's
tails, and the MCMC example's evidence falls some 6 standard errors short
at nlive 2000. The port takes the latent target (a deliberate difference,
ROADMAP §3).
"""

import datetime
import logging
import os
from typing import Optional

import numpy as np

from ....proposal.flowproposal.base import BaseFlowProposal
from .steps import KNOWN_STEPS

logger = logging.getLogger(__name__)

__all__ = ["MCMCFlowProposal"]


class MCMCFlowProposal(BaseFlowProposal):
    """Flow proposal whose pool comes from ensemble MCMC.

    The walkers start from the training data (drawn with replacement),
    moves are proposed in the latent space by the step ``step_type``
    (``"diff"``, ``"gaussian"`` or ``"stretch"``, with ``step_kwargs``)
    and accepted by the Metropolis-Hastings ratio of the prior over the
    flow's density (with the proposal's asymmetry), and, with
    ``enforce_likelihood_threshold``, only above the worst point's
    likelihood (the chain's target is the prior carried to the latent
    space, see the module's notes). ``n_steps`` steps a populate; with ``n_accept``, steps
    until the mean number of acceptances per walker reaches it (at most
    ``max(10 n_steps, 100)``). Ensemble steps take their partners from a
    share ``ensemble_fraction`` of the walkers. ``mcmc_history`` records
    each populate's acceptance and steps; ``plot_chain`` and
    ``plot_history`` plot them.
    """

    def __init__(
        self,
        model,
        n_steps: int = 10,
        n_accept: Optional[int] = None,
        step_type: str = "diff",
        step_kwargs: Optional[dict] = None,
        plot_chain: bool = False,
        plot_history: bool = False,
        enforce_likelihood_threshold: bool = True,
        ensemble_fraction: float = 0.5,
        **kwargs,
    ):
        super().__init__(model, **kwargs)
        self.n_steps = int(n_steps)
        self.n_accept = n_accept
        if step_type not in KNOWN_STEPS:
            raise ValueError(f"Unknown step type: {step_type}. Known: {sorted(KNOWN_STEPS)}")
        self.step_type = step_type
        self.step_kwargs = dict(step_kwargs or {})
        self._step = None
        self._plot_chain = plot_chain
        self._plot_history = plot_history
        self.enforce_likelihood_threshold = enforce_likelihood_threshold
        if not 0.0 < ensemble_fraction <= 1.0:
            raise ValueError("ensemble_fraction must be in (0, 1]")
        self.ensemble_fraction = ensemble_fraction
        self.mcmc_history = {"acceptance": [], "n_steps": []}

    def initialise(self, resumed: bool = False) -> None:
        super().initialise(resumed=resumed)
        if self._step is None:
            self._step = KNOWN_STEPS[self.step_type](self.prime_dims, rng=self.rng, **self.step_kwargs)

    def _latent_to_x(self, z):
        """Every walker's x and ``log|dx/dz|`` (the flow's inverse and the
        inverse reparameterisations), in order; a walker out of bounds is
        rejected through its prior."""
        x_prime_array, log_j = self.flow.inverse(z)
        x_prime = np.zeros(len(x_prime_array), dtype=self.x_prime_dtype)
        for i, p in enumerate(self.prime_parameters):
            x_prime[p] = x_prime_array[:, i]
        x, log_j_inv = self.inverse_rescale(x_prime, return_unit_hypercube=True)
        return x, log_j + log_j_inv

    def _masked_log_prior(self, x):
        """The log-prior, -inf out of bounds or where it is not a number."""
        in_b = self.model.in_unit_hypercube(x) if self.map_to_unit_hypercube else self.model.in_bounds(x)
        log_p = np.full(len(x), -np.inf)
        if in_b.any():
            with np.errstate(all="ignore"):
                lp = self.log_prior(x)
            log_p[in_b] = np.asarray(lp)[in_b]
        return np.nan_to_num(log_p, nan=-np.inf)

    def populate(self, worst_point, n_samples=10000, plot=True, r=None) -> None:
        """Fill the pool with the ``n_samples`` walkers after the MCMC
        steps (``r`` is taken and unused, as in the JAX package)."""
        st = datetime.datetime.now()
        if not self.initialised:
            raise RuntimeError("Proposal has not been initialised")
        logL_threshold = float(np.atleast_1d(worst_point["logL"])[0]) if worst_point is not None else -np.inf
        if self.training_data is None:
            raise RuntimeError("MCMC proposal requires training data")
        x_start = self._convert_to_x(self.training_data.copy())
        idx = self.rng.integers(0, len(x_start), n_samples)
        x_start = x_start[idx]
        z_walkers, _ = self.forward_pass(x_start)
        x_cur, log_j_cur = self._latent_to_x(z_walkers)
        log_p = self._masked_log_prior(x_cur)
        logL = self.model.batch_evaluate_log_likelihood(x_cur, unit_hypercube=self.map_to_unit_hypercube)

        n_accept_total = 0
        n_prop_total = 0
        n_walkers = len(z_walkers)
        max_steps = self.n_steps if self.n_accept is None else max(10 * self.n_steps, 100)
        steps_taken = 0
        z_chain = [z_walkers.copy()] if self._plot_chain else None
        for _ in range(max_steps):
            if self._step.requires_ensemble:
                n_ens = max(int(self.ensemble_fraction * n_walkers), 2)
                ens_idx = self.rng.choice(n_walkers, n_ens, replace=False)
                self._step.update_ensemble(z_walkers[ens_idx])
            z_new, log_ratio = self._step.propose(z_walkers)
            x_new, log_j_new = self._latent_to_x(z_new)
            log_p_new = self._masked_log_prior(x_new)
            logL_new = self.model.batch_evaluate_log_likelihood(x_new, unit_hypercube=self.map_to_unit_hypercube)
            with np.errstate(invalid="ignore"):
                log_alpha = (log_p_new + log_j_new) - (log_p + log_j_cur) + log_ratio
            u = np.log(self.rng.random(len(z_walkers)))
            accept = (u < np.nan_to_num(log_alpha, nan=-np.inf)) & np.isfinite(log_p_new)
            if self.enforce_likelihood_threshold:
                accept &= logL_new > logL_threshold
            z_walkers = np.where(accept[:, None], z_new, z_walkers)
            x_cur[accept] = x_new[accept]
            log_p = np.where(accept, log_p_new, log_p)
            log_j_cur = np.where(accept, log_j_new, log_j_cur)
            logL = np.where(accept, logL_new, logL)
            n_accept_total += int(accept.sum())
            n_prop_total += len(accept)
            self._step.update(float(accept.mean()))
            steps_taken += 1
            if z_chain is not None:
                z_chain.append(z_walkers.copy())
            if self.n_accept is not None and n_accept_total / n_walkers >= self.n_accept:
                break
        acceptance = n_accept_total / n_prop_total if n_prop_total else np.nan
        self.mcmc_history["acceptance"].append(acceptance)
        self.mcmc_history["n_steps"].append(steps_taken)

        samples = x_cur.copy()
        samples["logP"] = log_p
        samples["logL"] = logL
        self.x = samples
        self.samples = self.convert_to_samples(samples)
        self.samples["logL"] = logL
        self.population_time += datetime.datetime.now() - st
        self.population_acceptance = acceptance
        self.indices = self.rng.permutation(len(self.samples)).tolist()
        self.populated_count += 1
        self.populated = True
        if z_chain is not None:
            try:
                self.plot_chain(np.stack(z_chain))
            except Exception as e:
                logger.warning("Could not produce MCMC chain plot: %s", e)
        if self._plot_history and self.mcmc_history["acceptance"]:
            try:
                self.plot_history()
            except Exception as e:
                logger.warning("Could not produce MCMC history plot: %s", e)

    def plot_chain(self, chains) -> None:
        """Plot the latent walker chains ``chains`` ([n_steps, n_chains,
        n_dims]) to ``chain_<populate>.png``."""
        import matplotlib.pyplot as plt

        chains = np.asarray(chains)
        ndims = chains.shape[2]
        fig, axs = plt.subplots(ndims, 1, sharex=True, figsize=(6, 2 * ndims))
        axs = np.atleast_1d(axs)
        for j in range(ndims):
            axs[j].plot(chains[:, :, j], lw=0.5, alpha=0.5)
            axs[j].set_ylabel(f"z_{j}")
        axs[-1].set_xlabel("step")
        fig.tight_layout()
        fig.savefig(os.path.join(self.output, f"chain_{self.populated_count}.png"))
        plt.close(fig)

    def plot_history(self) -> None:
        """Plot each populate's acceptance and steps to
        ``mcmc_history.png``."""
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(2, 1, sharex=True)
        axs[0].plot(self.mcmc_history["acceptance"])
        axs[0].set_ylabel("Acceptance")
        axs[1].plot(self.mcmc_history["n_steps"])
        axs[1].set_ylabel("Number of steps")
        axs[-1].set_xlabel("Iteration")
        fig.tight_layout()
        fig.savefig(os.path.join(self.output, "mcmc_history.png"))
        plt.close(fig)
