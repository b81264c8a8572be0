"""Augmented flow proposal (arXiv:2002.07101): the flow's input gets
``augment_dims`` extra Gaussian dimensions. Counterpart of
``nessai_tpu/proposal/augmented.py``.

The stack of reparameterisations covers the model's parameters only, so
a populate inverts them on the host (:meth:`FlowProposal._host_backward`)
after the flow inverse on the device; with ``marginalise_augment`` the
pool's log q is a Monte-Carlo marginal over the augment dimensions, one
flow forward over ``n * n_marg`` rows.
"""

import logging

import numpy as np
from scipy.special import logsumexp
from scipy.stats import norm

from ..livepoint import empty_structured_array, live_points_to_array
from .flowproposal import FlowProposal
from .flowproposal.base import BaseFlowProposal

logger = logging.getLogger(__name__)

__all__ = ["AugmentedFlowProposal"]


class AugmentedFlowProposal(FlowProposal):
    """FlowProposal with ``augment_dims`` auxiliary N(0, 1) dimensions
    ``e_0, e_1, ...``.

    The flow trains on [x', e], with e drawn afresh from the unit
    Gaussian at each training (``generate_augment="gaussian"``) or zero
    (``"zeros"``), and its coupling mask is fixed: the real dimensions in
    one half, the augment dimensions in the other. The augment dimensions
    have a unit-Gaussian prior, or with ``marginalise_augment`` log q is
    marginalised over them with ``n_marg`` draws a sample.
    """

    def __init__(
        self,
        model,
        augment_dims: int = 1,
        generate_augment: str = "gaussian",
        marginalise_augment: bool = False,
        n_marg: int = 50,
        **kwargs,
    ):
        super().__init__(model, **kwargs)
        self.augment_dims = int(augment_dims)
        if generate_augment not in ("gaussian", "zeros", "zeroes"):
            raise RuntimeError(f"Unknown generate_augment: {generate_augment}")
        self.generate_augment = generate_augment
        self.marginalise_augment = marginalise_augment
        self.n_marg = int(n_marg)

    def set_rescaling(self) -> None:
        super().set_rescaling()
        self.augment_names = [f"e_{i}" for i in range(self.augment_dims)]
        self.parameters = self.parameters + self.augment_names
        self.prime_parameters = self.prime_parameters + self.augment_names
        self._base_dims = self.prime_dims - self.augment_dims

    def update_flow_config(self, flow_config: dict) -> dict:
        """The fixed coupling mask: 1 (identity) on the real dimensions,
        -1 on the augment dimensions, and its complement in turn."""
        flow_config = dict(flow_config)
        if "mask" not in flow_config:
            m = np.ones(self.prime_dims, dtype=int)
            m[-self.augment_dims :] = -1
            flow_config["mask"] = m
        return flow_config

    def rescale(self, x, compute_radius: bool = False):
        """Rescale, then fill the augment columns: unit-Gaussian draws
        from ``rng`` (zeros with ``generate_augment="zeros"`` or
        ``compute_radius``)."""
        x_prime, log_j = super().rescale(x, compute_radius=compute_radius)
        n = len(x_prime)
        if self.generate_augment == "gaussian" and not compute_radius:
            e = self.rng.standard_normal((n, self.augment_dims))
        else:
            e = np.zeros((n, self.augment_dims))
        for i, name in enumerate(self.augment_names):
            x_prime[name] = e[:, i]
        return x_prime, log_j

    def inverse_rescale(self, x_prime, **kwargs):
        x, log_j = super().inverse_rescale(x_prime, **kwargs)
        for name in self.augment_names:
            x[name] = x_prime[name]
        return x, log_j

    def augmented_prior(self, x):
        """The unit-Gaussian log-prior of the augment columns."""
        log_p = 0.0
        for name in self.augment_names:
            log_p = log_p + norm.logpdf(x[name])
        return log_p

    def log_prior(self, x):
        if self.marginalise_augment:
            return super().log_prior(x)
        return super().log_prior(x) + self.augmented_prior(x)

    def _marginalise_augment(self, x_prime_array):
        """log q of each row's real dimensions, marginalised over the
        augment dimensions with ``n_marg`` unit-Gaussian draws (from
        ``rng``): ``log mean_e q(x', e) / N(e)``."""
        n = len(x_prime_array)
        real = np.repeat(x_prime_array[:, : self._base_dims], self.n_marg, axis=0)
        e = self.rng.standard_normal((n * self.n_marg, self.augment_dims))
        full = np.concatenate([real, e], axis=1)
        _, log_prob = self.flow.forward_and_log_prob(full)
        log_prob_e = norm.logpdf(e).sum(axis=1)
        return -np.log(self.n_marg) + logsumexp((log_prob - log_prob_e).reshape(n, self.n_marg), axis=1)

    def _host_backward(self, x_prime, log_q):
        """The host inverse of :class:`FlowProposal`; with
        ``marginalise_augment`` the log q of the draws in bounds is the
        marginal over the augment dimensions of their rescaled points."""
        x_arr, log_q, log_l, in_b = super()._host_backward(x_prime, log_q)
        keep = in_b & np.isfinite(log_q)
        if self.marginalise_augment and keep.any():
            x = empty_structured_array(int(keep.sum()), dtype=self.x_dtype)
            for i, name in enumerate(self.parameters):
                x[name] = x_arr[keep, i]
            x_prime_kept, _ = BaseFlowProposal.rescale(self, x)
            log_q = log_q.copy()
            log_q[keep] = self._marginalise_augment(live_points_to_array(x_prime_kept, self.prime_parameters))
        return x_arr, log_q, log_l, in_b
