"""Rejection proposal for the uninformed phase. Counterpart of
``nessai_tpu/proposal/rejection.py``: prior draws (``model.new_point``)
rejected against the prior; the pool's likelihoods are one batched
evaluation (on the device for models with a ``torch_log_likelihood``).

For a uniform box prior with a device likelihood the whole populate is
one device call (:meth:`RejectionProposal._device_populate`): uniform
draws in the box and their likelihoods, every draw accepted, with the
nested-sampling scan chained on where the sampler asks for it."""

import datetime
import types

import numpy as np
import torch

from ..livepoint import empty_structured_array
from ..utils.device import get_device
from ..utils.profiling import annotate, counts
from ..utils.sampling import _bucket_size
from .analytic import AnalyticProposal

__all__ = ["RejectionProposal", "prior_populate_counts"]

#: Device populates of the prior (and the scans chained onto them) since
#: the counts were last set to 0.
prior_populate_counts = types.SimpleNamespace(populates=0, chained_scans=0)


class RejectionProposal(AnalyticProposal):
    """Draw from ``model.new_point`` and reject against the prior so the
    pool is exactly prior-distributed."""

    #: cap on the adaptive pool growth
    max_poolsize_scale: float = 4.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.population_acceptance = None
        #: NS mean block acceptance, pushed by the sampler
        self.ns_acceptance = None
        self._pool_scale = 1.0

    @property
    def _device_populate_ok(self) -> bool:
        """Whether the populate runs as one device call, by the JAX
        package's rule (``rejection.py:43-75``): a device likelihood, a
        uniform box prior with finite bounds, and ``new_point``,
        ``new_point_log_prob``, :meth:`draw_proposal`,
        :meth:`log_proposal` and :meth:`compute_weights` as the base
        classes define them. Cached."""
        cached = getattr(self, "_device_populate_cached", None)
        if cached is not None:
            return cached
        from ..model import Model

        m = self.model
        ok = bool(
            m is not None
            and m.has_torch_likelihood
            and m.has_uniform_box_prior
            and type(m).new_point is Model.new_point
            and type(m).new_point_log_prob is Model.new_point_log_prob
            and type(self).draw_proposal is RejectionProposal.draw_proposal
            and type(self).log_proposal is RejectionProposal.log_proposal
            and type(self).compute_weights is RejectionProposal.compute_weights
            and np.all(np.isfinite(m.lower_bounds))
            and np.all(np.isfinite(m.upper_bounds))
        )
        self._device_populate_cached = ok
        return ok

    @torch.no_grad()
    def _device_populate(self, N: int) -> None:
        """One device call (``rejection.py:77-192``): ``_bucket_size(N)``
        uniform draws in the prior box from a device generator and the
        model's device likelihood (:meth:`Model.device_log_likelihood_fn`)
        on them. The uniform box prior makes every weight the same, so every
        draw is accepted and the pool is exactly prior-distributed. The host
        stream ``rng`` gives the pop order first, then the generator's seed,
        as in the JAX package; where the sampler asks for the
        nested-sampling scan (``_ns_scan_request``), it runs on the pool's
        likelihoods in pop order and its outputs wait in
        ``_pending_ns_scan``."""
        m = self.model
        device = get_device(m.device)
        d = m.dims
        N = _bucket_size(int(N))
        perm = self.rng.permutation(N)
        scan_req = getattr(self, "_ns_scan_request", None)
        self._pending_ns_scan = None
        seed = int(self.rng.integers(2**31 - 1))
        gen = torch.Generator(device=device).manual_seed(seed)
        lower = torch.as_tensor(np.asarray(m.lower_bounds, np.float32), device=device)
        upper = torch.as_tensor(np.asarray(m.upper_bounds, np.float32), device=device)
        x = lower + torch.rand(N, d, generator=gen, device=device) * (upper - lower)
        ll_fn, ll_data = m.device_log_likelihood_fn(device)
        log_l = ll_fn(x, ll_data).to(torch.float32)
        prior_populate_counts.populates += 1
        if scan_req is not None:
            from ..samplers.ns_device import chain_scan

            with annotate("scan"):
                self._pending_ns_scan = chain_scan(log_l, perm, *scan_req)
            prior_populate_counts.chained_scans += 1
        out = torch.cat([x, log_l[:, None]], dim=1).cpu().numpy().astype(np.float64)
        counts.host_reads += 1
        samples = empty_structured_array(N, names=m.names)
        for i, name in enumerate(m.names):
            samples[name] = out[:, i]
        samples["logP"] = -np.sum(np.log(np.asarray(m.upper_bounds, float) - np.asarray(m.lower_bounds, float)))
        samples["logL"] = out[:, d]
        m.likelihood_evaluations += N
        self.samples = samples
        self.population_acceptance = 1.0
        self.indices = perm.tolist()

    def draw_proposal(self, N=None):
        return self.model.new_point(N=self.poolsize if N is None else N)

    def log_proposal(self, x):
        return self.model.new_point_log_prob(x)

    def compute_weights(self, x):
        """logW = logP - logQ, with logQ the density of ``new_point``."""
        x["logP"] = self.model.batch_evaluate_log_prior(x)
        return x["logP"] - self.log_proposal(x)

    def populate(self, N=None) -> None:
        if N is None:
            # the uninformed phase consumes ~1/X pool entries per
            # iteration: grow the pool geometrically (and at least with
            # the observed 1/acceptance), capped
            scale = self._pool_scale
            acc = self.ns_acceptance
            if acc is not None and np.isfinite(acc) and 0.0 < acc < 1.0:
                scale = max(scale, 1.0 / acc)
            scale = min(self.max_poolsize_scale, scale)
            N = int(self.poolsize * scale)
            self._pool_scale = min(self.max_poolsize_scale, self._pool_scale * 1.6)
        with annotate("populate") as span:
            span.set(pool=span.id)
            self.pool_id = span.id
            st = datetime.datetime.now()
            if self._device_populate_ok:
                self._device_populate(N)
            else:
                x = self.draw_proposal(N=N)
                log_w = self.compute_weights(x)
                log_w = log_w - np.nanmax(log_w)
                log_u = np.log(self.rng.random(N))
                self.samples = x[np.flatnonzero(log_w > log_u)]
                self.population_acceptance = self.samples.size / N
                self.indices = self.rng.permutation(self.samples.size).tolist()
                self.samples["logL"] = self.model.batch_evaluate_log_likelihood(self.samples)
            self.population_time += datetime.datetime.now() - st
            self.populated = True
