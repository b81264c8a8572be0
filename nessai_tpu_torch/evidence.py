"""Evidence integration for both samplers. Counterpart of
``_NSIntegralState``, ``_INSIntegralState`` and
``log_evidence_from_ins_samples`` in ``nessai_tpu/evidence.py``.

One repair against the JAX package: :meth:`simulate_log_evidence` keeps
its scratch in float64. The JAX package exponentiates the cumulative
log-shrinkage in float32, so beyond ~87 nats of compression every row
underflows to zero and the simulated error becomes NaN.
"""

import logging
import math
from typing import List, Optional

import numpy as np
from scipy.special import logsumexp

from .utils.stats import effective_sample_size

logger = logging.getLogger(__name__)

__all__ = [
    "logsubexp",
    "log_integrate_log_trap",
    "_NSIntegralState",
    "_INSIntegralState",
    "log_evidence_from_ins_samples",
]


def logsubexp(x, y):
    """log(exp(x) - exp(y)), elementwise, requires x >= y."""
    if np.any(x < y):
        raise RuntimeError("cannot take log of negative number")
    return x + np.log1p(-np.exp(y - x))


def log_integrate_log_trap(log_func, log_support):
    """Trapezoid rule in log space."""
    log_func_sum = np.logaddexp(log_func[:-1], log_func[1:]) - np.log(2)
    log_dxs = logsubexp(log_support[:-1], log_support[1:])
    return logsumexp(log_func_sum + log_dxs)


class _NSIntegralState:
    """Streaming nested-sampling evidence: logsumexp rectangle rule with
    shrinkage ``logt = -1/nlive`` and a trapezoid re-integration at
    :meth:`finalise`."""

    def __init__(self, nlive: int):
        self.base_nlive = int(nlive)
        self.reset()

    def reset(self) -> None:
        self.logZ = -np.inf
        self.oldZ = -np.inf
        self.logw = 0.0
        self.nonmonotonic_count = 0
        self.info = [0.0]
        self.logLs: List[float] = [-np.inf]
        self.log_vols: List[float] = [0.0]
        self.nlives: List[int] = []

    def increment(self, logL, nlive: Optional[int] = None) -> None:
        """Update the evidence with the next dead point's logL (scalar
        ``math``, as the JAX package does, for bit-identical results)."""
        logL = float(np.atleast_1d(logL)[0])
        if nlive is None:
            nlive = self.base_nlive
        if logL <= self.logLs[-1]:
            self.nonmonotonic_count += 1
            if self.nonmonotonic_count <= 5:
                logger.warning(
                    "NS integrator received non-monotonic logL: %.5f -> %.5f",
                    self.logLs[-1],
                    logL,
                )
            elif self.nonmonotonic_count % 1000 == 0:
                logger.warning(
                    "NS integrator received %d non-monotonic logL values so "
                    "far (ties are expected with float32 device likelihoods)",
                    self.nonmonotonic_count,
                )
        logt = -1.0 / nlive
        Wt = self.logw + logL + math.log(-math.expm1(logt))
        if Wt > self.logZ:
            self.logZ = Wt + math.log1p(math.exp(self.logZ - Wt))
        elif Wt == -math.inf:
            pass
        else:
            self.logZ = self.logZ + math.log1p(math.exp(Wt - self.logZ))
        if math.isfinite(self.oldZ):
            info = (
                math.exp(Wt - self.logZ) * logL
                + math.exp(self.oldZ - self.logZ) * (self.info[-1] + self.oldZ)
                - self.logZ
            )
            self.info.append(0.0 if math.isnan(info) else info)
        else:
            self.info.append(0.0)
        self.oldZ = self.logZ
        self.logw += logt
        self.logLs.append(logL)
        self.log_vols.append(self.logw)
        self.nlives.append(int(nlive))

    @property
    def log_evidence(self) -> float:
        return float(self.logZ)

    @property
    def log_evidence_error(self) -> float:
        """sqrt(H / nlive)."""
        return float(np.sqrt(max(self.info[-1], 0.0) / self.base_nlive))

    def finalise(self) -> float:
        """Re-integrate with the trapezoid rule, closing at X=0 with an
        extra point at max(L)."""
        self.logZ = float(
            log_integrate_log_trap(
                np.array(self.logLs + [self.logLs[-1]]),
                np.array(self.log_vols + [-np.inf]),
            )
        )
        return self.logZ

    def _nlive_schedule(self) -> np.ndarray:
        n_iter = len(self.logLs) - 1
        nlives = list(self.nlives)
        if len(nlives) < n_iter:
            nlives = [self.base_nlive] * (n_iter - len(nlives)) + nlives
        return np.asarray(nlives[:n_iter], dtype=float)

    def simulate_log_evidence(self, n_simulations: int = 500, rng=None) -> np.ndarray:
        """Monte-Carlo draws of logZ under simulated prior-volume
        contractions (``log t_i = -Exp(1)/nlive_i``), re-integrated with
        the trapezoid rule of :meth:`finalise`; ``std`` of the result is
        the simulated error.

        The exponential draws are float32, as in the JAX package, so one
        seed gives the same contractions in both; the cumulative sum,
        the exponential and the matrix-vector product are float64."""
        if rng is None:
            rng = np.random.default_rng()
        log_L = np.asarray(self.logLs + [self.logLs[-1]])
        n_iter = len(self.logLs) - 1
        if n_iter < 1:
            return np.full(int(n_simulations), -np.inf)
        neg_inv_nlives = -1.0 / self._nlive_schedule()
        log_f_sum = np.logaddexp(log_L[:-1], log_L[1:]) - np.log(2)
        # logZ = M + log(w_0 + X_inner @ (w[1:] - w[:-1])), with
        # w = exp(log_f_sum - M) and X the simulated volumes
        M = float(np.max(log_f_sum))
        w = np.exp(log_f_sum - M)
        w0 = float(w[0])
        dw = w[1:] - w[:-1]
        n_simulations = int(n_simulations)
        chunk = max(1, min(n_simulations, int(1e7) // max(n_iter, 1)))
        out = np.empty(n_simulations)
        for s0 in range(0, n_simulations, chunk):
            s = min(chunk, n_simulations - s0)
            e = rng.standard_exponential((s, n_iter), dtype=np.float32).astype(np.float64)
            e *= neg_inv_nlives
            np.cumsum(e, axis=1, out=e)
            np.exp(e, out=e)
            out[s0 : s0 + s] = M + np.log(w0 + e @ dw)
        return out

    def log_posterior_weights(self):
        """Posterior weight of every dead point."""
        log_L = np.array(self.logLs + [self.logLs[-1]])
        log_vols = np.array(self.log_vols + [-np.inf])
        log_Z = log_integrate_log_trap(log_L, log_vols)
        log_w = logsubexp(log_vols[:-1], log_vols[1:])
        return log_L[1:-1] + log_w[:-1] - log_Z

    def plot(self, filename=None):
        """log-likelihood against log prior volume (needs matplotlib);
        saved to ``filename`` or returned as a figure."""
        import matplotlib.pyplot as plt

        fig = plt.figure()
        plt.plot(self.log_vols, self.logLs)
        plt.title(f"logZ={self.logZ:.2f} H={self.info[-1] * np.log2(np.e):.2f} bits")
        plt.grid(which="both")
        plt.xlabel("log prior-volume")
        plt.ylabel("log-likelihood")
        plt.xlim([self.log_vols[-1], self.log_vols[0]])
        if filename is not None:
            fig.savefig(filename, bbox_inches="tight")
            plt.close(fig)
            return None
        return fig


class _INSIntegralState:
    """Evidence state of the importance nested sampler: a Monte-Carlo
    mean over every sample, ``Z = mean(exp(logL + logW))``, with
    ``logW = logU - logQ`` the meta-proposal weights. The weights are
    held in ``longdouble``, as in the JAX package."""

    def __init__(self):
        self._weights_nested = None
        self._weights_live = None
        self._previous_logZ = -np.inf

    def update_evidence(self, nested_samples, live_points=None) -> None:
        """Recompute from the full sample sets."""
        self._previous_logZ = self.log_evidence if self.n else -np.inf
        log_z_nested = nested_samples["logL"] + nested_samples["logW"]
        self._weights_nested = np.asarray(log_z_nested, dtype=np.longdouble)
        if live_points is not None:
            log_z_live = live_points["logL"] + live_points["logW"]
            self._weights_live = np.asarray(log_z_live, dtype=np.longdouble)
        else:
            self._weights_live = None

    @property
    def _all_weights(self):
        if self._weights_nested is None:
            return None
        if self._weights_live is not None:
            return np.concatenate([self._weights_nested, self._weights_live])
        return self._weights_nested

    @property
    def n(self) -> int:
        w = self._all_weights
        return len(w) if w is not None else 0

    @property
    def log_posterior_weights(self) -> np.ndarray:
        """Log-posterior weight of every sample (live points included
        when set)."""
        w = self._all_weights
        if w is None:
            return np.empty(0)
        return np.asarray(w, dtype=float) - self.log_evidence

    @property
    def log_evidence(self) -> float:
        w = self._all_weights
        if w is None or not len(w):
            return -np.inf
        return float(logsumexp(w.astype(float)) - np.log(len(w)))

    logZ = log_evidence

    @property
    def evidence(self) -> float:
        return float(np.exp(self.log_evidence))

    @property
    def log_evidence_nested_samples(self) -> float:
        """Evidence of the nested samples, normalised by their count."""
        w = self._weights_nested
        if w is None or not len(w):
            return -np.inf
        return float(logsumexp(w.astype(float)) - np.log(len(w)))

    @property
    def log_evidence_live_points(self) -> float:
        """Evidence of the live points; raises if they are not set."""
        w = self._weights_live
        if w is None:
            raise RuntimeError("Live points are not set")
        if not len(w):
            return -np.inf
        return float(logsumexp(w.astype(float)) - np.log(len(w)))

    @property
    def log_evidence_error(self) -> float:
        return self.compute_uncertainty()

    @property
    def evidence_error(self) -> float:
        """Linear-space standard error."""
        return self.compute_uncertainty(log_evidence=False)

    @property
    def fractional_error(self) -> float:
        return float(self.evidence_error / self.evidence)

    @property
    def difference_log_evidence(self) -> float:
        """|logZ - previous logZ| across evidence updates."""
        return float(np.abs(self.logZ - self._previous_logZ))

    def compute_uncertainty(self, log_evidence: bool = True) -> float:
        """Standard error of the Monte-Carlo evidence (relative, which is
        the error of log Z, if ``log_evidence``, else linear), summed in
        ``longdouble``."""
        w = self._all_weights
        if w is None or len(w) < 2:
            return np.inf
        n = len(w)
        Z_hat = np.exp(logsumexp(w) - np.log(n), dtype=np.longdouble)
        u = np.exp(w, dtype=np.longdouble)
        se = np.sqrt(np.sum((u - Z_hat) ** 2) / (n * (n - 1)))
        if log_evidence:
            return float(se / Z_hat)
        return float(se)

    def compute_log_evidence_ratio(self, ns_only: bool = False) -> float:
        """log(Z_live / Z_nested) with ``ns_only``, else log(Z_live /
        Z_total)."""
        if ns_only:
            return (
                self.log_evidence_live_points
                - self.log_evidence_nested_samples
            )
        return self.log_evidence_live_points - self.log_evidence

    @property
    def log_evidence_ratio(self) -> float:
        """log(Z_live / Z_total): the default stopping quantity."""
        return float(self.compute_log_evidence_ratio(ns_only=False))

    @property
    def log_evidence_ratio_nested_samples(self) -> float:
        return float(self.compute_log_evidence_ratio(ns_only=True))

    @property
    def effective_n_posterior_samples(self) -> float:
        """Kish effective sample size of the posterior weights."""
        w = self._all_weights
        if w is None or not len(w):
            return 0.0
        return effective_sample_size(w.astype(float))

    ess = effective_n_posterior_samples


def log_evidence_from_ins_samples(samples) -> float:
    """Evidence from a set of importance nested samples."""
    return float(
        logsumexp(samples["logL"] + samples["logW"]) - np.log(len(samples))
    )
