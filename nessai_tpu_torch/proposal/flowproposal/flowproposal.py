"""FlowProposal: the flagship proposal. Counterpart of
``nessai_tpu/proposal/flowproposal/flowproposal.py`` (its ``rounds``
populate).

Each populate round draws latent points on the host (the truncated
Gaussian, from ``self.rng``), then one device call,
:meth:`FlowProposal._fused_backward`, takes them through the flow inverse
(four affine-coupling kernel launches for the flagship RealNVP), the base
log-density, the inverse reparameterisation (each stack member's
``torch_inverse``), the prior-bounds check and the model's
``torch_log_likelihood``; rejection sampling against the prior runs on
the host.
"""

import datetime
import logging

import numpy as np
import torch

from ...flows.distributions import StandardNormal
from ...livepoint import empty_structured_array
from .base import BaseFlowProposal
from .truncation import LatentRadiusTruncation

logger = logging.getLogger(__name__)

__all__ = ["FlowProposal"]


class FlowProposal(BaseFlowProposal):
    """Flow proposal with latent truncation and rejection sampling.

    Each round draws ``poolsize`` latent points, scaled up by the
    previous populate's 1/acceptance (capped). One populate stops after
    :attr:`max_samples` draws.
    """

    #: cap on the acceptance-adaptive latent draw scale
    _max_draw_scale: float = 32.0
    #: latent draws after which one populate gives up
    max_samples: int = 1_000_000

    def initialise(self, resumed: bool = False) -> None:
        super().initialise(resumed=resumed)
        self._truncation = LatentRadiusTruncation(self.prime_dims, rng=self.rng)
        #: stack members whose host inverse has been logged
        self._logged_host_inverse = set()

    @property
    def _draw_n(self) -> int:
        """Latent draws per populate round."""
        n = int(self._poolsize)
        acc = self.population_acceptance
        if acc is not None and np.isfinite(acc) and 0 < acc < 1:
            n = int(n * min(max(1.0 / acc, 1.0), self._max_draw_scale))
        return n

    @torch.no_grad()
    def sample_latent_distribution(self, n: int) -> np.ndarray:
        """The latent draws of a populate round, before the radius cut: for
        a unit-Gaussian base the truncated Gaussian of the latent radius,
        drawn on the host from ``rng``; for any other base (LARS, a scaled
        Gaussian, the uniform box) draws from the base on the device, as
        the JAX package's device populate loop draws them
        (``nessai_tpu/proposal/flowproposal/flowproposal.py:773``); the
        radius then cuts both."""
        base = self.flow.flow.base
        if type(base) is StandardNormal:
            return self._truncation.sample_latent(n)
        return base.sample(n, self.flow.device_generator()).double().cpu().numpy()

    @torch.no_grad()
    def _fused_backward(self, z, with_likelihood: bool = True):
        """One device call: latent ``z`` -> x (one column per entry of
        :attr:`parameters`: the model's names, then auxiliary parameters
        such as a sampled radius), log q(x), [logL,] and the in-bounds
        mask over the model's names. Returns float64 numpy arrays
        (``log_l`` is None without the likelihood).

        Where a member of the stack has no device inverse, the flow
        inverse still runs here and the inverse reparameterisation runs
        on the host (:meth:`_host_backward`)."""
        device = self.device
        model = self.model
        flow = self.flow.flow
        zt = torch.as_tensor(np.asarray(z, np.float32), device=device)
        x_prime, log_q = flow.inverse_and_log_prob(zt)
        cols = {pp: x_prime[:, i] for i, pp in enumerate(self.prime_parameters)}
        inverted = self._reparameterisation.torch_inverse(cols)
        if inverted is None:
            return self._host_backward(x_prime, log_q)
        cols, log_j = inverted
        log_q = log_q - log_j
        x = torch.stack([cols[p] for p in self.parameters], dim=1)
        x_model = x[:, : len(model.names)]
        lower = torch.as_tensor(model.lower_bounds, dtype=torch.float32, device=device)
        upper = torch.as_tensor(model.upper_bounds, dtype=torch.float32, device=device)
        in_b = torch.all((x_model >= lower) & (x_model <= upper), dim=1)
        columns = [x, log_q[:, None], in_b[:, None].to(x.dtype)]
        if with_likelihood:
            columns.append(model.torch_log_likelihood(x_model)[:, None])
        # one device -> host copy for everything
        out = torch.cat(columns, dim=1).cpu().numpy().astype(np.float64)
        d = x.shape[1]
        log_l = out[:, d + 2] if with_likelihood else None
        return out[:, :d], out[:, d], log_l, out[:, d + 1] > 0.5

    def _host_backward(self, x_prime, log_q):
        """The flow's output copied to the host and inverted there by the
        stack's numpy ``inverse_reparameterise``, as the JAX package's
        rounds populate does where its stack has no device inverse; the
        likelihood is then evaluated on the accepted pool."""
        if self._reparameterisation.no_torch_inverse not in self._logged_host_inverse:
            self._logged_host_inverse.add(self._reparameterisation.no_torch_inverse)
            logger.info(
                "%s has no device inverse: the inverse reparameterisation runs on the host",
                self._reparameterisation.no_torch_inverse,
            )
        out = torch.cat([x_prime, log_q[:, None]], dim=1).cpu().numpy().astype(np.float64)
        x_prime_host = np.zeros(len(out), dtype=self.x_prime_dtype)
        for i, pp in enumerate(self.prime_parameters):
            x_prime_host[pp] = out[:, i]
        x, log_j = self.inverse_rescale(x_prime_host)
        x_arr = np.stack([x[p] for p in self.parameters], axis=1)
        return x_arr, out[:, -1] - log_j, None, self.model.in_bounds(x)

    def populate(self, worst_point, n_samples: int = 10000) -> None:
        """Fill the pool with ``n_samples`` accepted draws."""
        st = datetime.datetime.now()
        if not self.initialised:
            raise RuntimeError("Proposal has not been initialised; call initialise() first")
        self.indices = []
        samples = empty_structured_array(n_samples, dtype=self.x_dtype)
        n_proposed = 0
        n_accepted = 0
        with_ll = self.model.has_torch_likelihood
        ll_in_pool = with_ll
        while n_accepted < n_samples:
            z = self.sample_latent_distribution(self._draw_n)
            n_proposed += len(z)
            z = self._truncation.apply_latent(z)
            if not len(z):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            st_lik = datetime.datetime.now()
            x_arr, log_q, log_l, in_b = self._fused_backward(z, with_likelihood=with_ll)
            ll_in_pool = log_l is not None
            if ll_in_pool:
                self.model.likelihood_evaluation_time += datetime.datetime.now() - st_lik
                self.model.likelihood_evaluations += len(z)
            keep = in_b & np.isfinite(log_q)
            x = empty_structured_array(int(keep.sum()), dtype=self.x_dtype)
            for i, name in enumerate(self.parameters):
                x[name] = x_arr[keep, i]
            if ll_in_pool:
                x["logL"] = log_l[keep]
            log_q = log_q[keep]
            if not len(x):
                if n_proposed > self.max_samples:
                    logger.warning("Reached max samples (%s)", self.max_samples)
                    break
                continue
            log_w = self.compute_weights(x, log_q)
            log_w = log_w - np.nanmax(log_w)
            log_u = np.log(self.rng.random(len(log_w)))
            batch_accept = log_w > log_u
            n_batch = int(batch_accept.sum())
            m = min(n_samples - n_accepted, n_batch)
            samples[n_accepted : n_accepted + m] = x[batch_accept][:m]
            n_accepted += n_batch
            if n_proposed > self.max_samples:
                logger.warning("Reached max samples (%s)", self.max_samples)
                break
        self.x = samples[: min(n_accepted, n_samples)]
        if not len(self.x):
            raise RuntimeError("Failed to populate the proposal pool (0 accepted samples)")
        self.samples = self.convert_to_samples(self.x)
        self.population_time += datetime.datetime.now() - st
        if not ll_in_pool:
            self.samples["logL"] = self.model.batch_evaluate_log_likelihood(self.samples)
        self.indices = self.rng.permutation(self.samples.size).tolist()
        self.population_acceptance = n_accepted / n_proposed if n_proposed else np.nan
        self.populated_count += 1
        self.populated = True
        if self._plot_pool:
            self.plot_pool(self.samples)
