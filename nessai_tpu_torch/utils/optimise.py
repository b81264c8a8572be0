"""Optimisation of the importance nested sampler's meta-proposal
weights. Counterpart of ``nessai_tpu/utils/optimise.py``: numpy and
scipy on the host."""

import logging

import numpy as np
from scipy.optimize import minimize
from scipy.special import logsumexp

logger = logging.getLogger(__name__)

__all__ = ["optimise_meta_proposal_weights"]


def optimise_meta_proposal_weights(
    samples: np.ndarray,
    log_q: np.ndarray,
    method="SLSQP",
    options: dict = None,
    initial_weights: np.ndarray = None,
    **kwargs,
):
    """Mixture weights of the meta-proposal that minimise the KL
    divergence between the posterior and the meta-proposal, on the
    simplex.

    ``samples`` is the structured samples array (fields ``logL`` and, for
    the default initial weights, ``it``) or a plain array of
    log-likelihoods; ``log_q`` is ``[n, n_proposals]``.
    ``initial_weights`` defaults to the draw counts per level for
    structured input and to uniform weights otherwise. An array in the
    ``method`` slot is taken as ``initial_weights`` (the older positional
    order). Returns the optimised weights, normalised.
    """
    if not isinstance(method, str):
        initial_weights = method
        method = "SLSQP"
    log_q = np.asarray(log_q, dtype=float)
    if isinstance(samples, np.ndarray) and samples.dtype.names is not None:
        logL = np.asarray(samples["logL"], dtype=float)
        if initial_weights is None and "it" in samples.dtype.names:
            counts = np.unique(samples["it"], return_counts=True)[1]
            initial_weights = counts / counts.sum()
    else:
        logL = np.asarray(samples, dtype=float)
    if initial_weights is None:
        initial_weights = np.full(log_q.shape[-1], 1.0 / log_q.shape[-1])
    initial_weights = np.asarray(initial_weights, dtype=float)
    initial_weights = initial_weights / initial_weights.sum()

    def loss(w):
        w = np.clip(w, 1e-300, None)
        log_Q = logsumexp(log_q, b=w[None, :], axis=1)
        log_w_post = logL - log_Q
        log_w_post -= logsumexp(log_w_post)
        # KL(posterior || meta-proposal) up to a constant
        return float(np.sum(np.exp(log_w_post) * (log_w_post + np.log(len(logL)))))

    constraints = {"type": "eq", "fun": lambda w: w.sum() - 1.0}
    bounds = [(0.0, 1.0)] * len(initial_weights)
    if options is None:
        options = {"maxiter": 200}
    result = minimize(
        loss,
        initial_weights,
        method=method,
        bounds=bounds,
        constraints=constraints,
        options=options,
        **kwargs,
    )
    if not result.success:
        logger.warning("Weight optimisation did not converge: %s", result.message)
    w = np.clip(result.x, 0, None)
    return w / w.sum()
