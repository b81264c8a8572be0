"""Meta-proposal of the importance nested sampler. Counterpart of
``nessai_tpu/proposal/importance.py``.

The meta-proposal is the prior (the uniform unit hypercube) and one flow
per level, each with a weight: ``log_Q = logsumexp(log_q, b=weights)``.
Samples live in the unit hypercube; the flows see them through a logit
map (``reparameterisation="logit"``) or as they are (``None``). The maps
and the meta-proposal run on the host in float64; the flows run on the
device (:class:`~nessai_tpu_torch.flowmodel.ImportanceFlowModel`).
"""

import logging
import os
from typing import Optional, Tuple

import numpy as np
from scipy.special import logsumexp

from .. import config as global_config
from ..flowmodel.importance import ImportanceFlowModel
from ..livepoint import empty_structured_array, live_points_to_array, numpy_array_to_live_points
from ..utils.device import get_device
from ..utils.rescaling import logit, sigmoid
from .base import Proposal

logger = logging.getLogger(__name__)

__all__ = ["ImportanceFlowProposal"]

#: A level's weight is NaN from its training until the sampler sets it.
#: The final flow (``train_final_flow``) is trained after the last level
#: and nothing sets its weight, as in the JAX package, which then fails
#: in a redraw or a bootstrap with an error of numpy's.
_UNSET_WEIGHT = (
    "a level's weight is NaN. The final flow (train_final_flow=True) leaves "
    "its level without a weight, so the meta-proposal cannot be drawn from or "
    "evaluated after it: do not combine train_final_flow with a redraw "
    "(redraw_samples) or with bootstrap"
)


class ImportanceFlowProposal(Proposal):
    """Meta-proposal: the prior and one flow per level, with weights.

    ``reset_flow`` is a bool (fresh weights for every level, or a copy of
    the previous level) or an int N (fresh weights every N levels).
    ``device`` (default CUDA) is where the flows train and run; with a
    ``mesh`` (:mod:`nessai_tpu_torch.parallel`) each level trains
    data-parallel over it and ``log_prob_all`` cuts its rows over it (the
    pickle holds no mesh: a resumed run is on one device). With
    ``weighted_kl`` each level trains on its samples weighted by their
    importance weights (the sampler passes False by default).
    """

    #: no mesh: the default of a proposal unpickled from before meshes
    mesh = None

    def __init__(
        self,
        model,
        output: str = "./",
        flow_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        reparameterisation: Optional[str] = "logit",
        weighted_kl: bool = True,
        reset_flow=True,
        rng=None,
        device=None,
        mesh=None,
    ):
        if reparameterisation not in ("logit", None, "none"):
            raise ValueError(f"Unknown reparameterisation: {reparameterisation}")
        super().__init__(model, rng=rng)
        self.output = output
        self.level_count = -1
        self.weighted_kl = weighted_kl
        self.reset_flow = int(reset_flow)
        self.reparameterisation = reparameterisation
        self.flow_config = dict(flow_config or {}, n_inputs=model.dims)
        self.training_config = training_config
        self.device = get_device(device)
        #: the device mesh the levels train and run on (None: one device)
        self.mesh = mesh
        self.flow = ImportanceFlowModel(
            flow_config=self.flow_config,
            training_config=training_config,
            output=output,
            rng=self.rng,
            device=self.device,
            mesh=mesh,
        )
        #: proposal weights keyed by level (-1 = prior)
        self._weights = {-1: 1.0}

    # ------------------------------------------------------------------
    @property
    def _reset_flow(self) -> bool:
        """Whether this level starts from fresh weights."""
        return bool(self.reset_flow) and not self.level_count % self.reset_flow

    @property
    def n_proposals(self) -> int:
        """Number of proposals in the meta-proposal (prior + flows)."""
        return len(self._weights)

    @property
    def weights(self) -> dict:
        return self._weights

    @property
    def weights_array(self) -> np.ndarray:
        return np.fromiter(self._weights.values(), dtype=float)

    def update_proposal_weights(self, weights: dict) -> None:
        """Update the proposal weights; they must sum to one after the
        update."""
        self._weights.update(weights)
        w_sum = np.sum(np.fromiter(self._weights.values(), float))
        if not np.isclose(w_sum, 1.0):
            raise RuntimeError(f"Weights must sum to 1! Actual value: {w_sum}")

    def initialise(self) -> None:
        os.makedirs(self.output, exist_ok=True)
        for field in ("logQ", "logW", "logU"):
            if field not in global_config.livepoints.non_sampling_parameters:
                raise RuntimeError(f"{field} field missing in non-sampling parameters.")
        self.flow.initialise()
        self.verify_rescaling()
        super().initialise()

    def update_output(self, output: str) -> None:
        """Move the output directory; the levels are saved there from now
        on."""
        super().update_output(output)
        self.flow.update_weights_path(self.output)

    def resume(self, model, flow_config=None, training_config=None, weights_path=None) -> None:
        """Rebind the model and rebuild the levels on :attr:`device` from
        their weight files (in ``weights_path``, by default
        :attr:`output`)."""
        super().resume(model)
        if flow_config is not None:
            self.flow_config = dict(flow_config, n_inputs=model.dims)
        if training_config is not None:
            self.training_config = training_config
        self.flow = ImportanceFlowModel(
            flow_config=self.flow_config,
            training_config=self.training_config,
            output=self.output,
            rng=self.rng,
            device=self.device,
        )
        self.flow.resume(weights_path=weights_path or self.output)

    def __getstate__(self):
        """The flows stay out of the pickle: their levels are weight
        files."""
        state = super().__getstate__()
        state["flow"] = None
        state["mesh"] = None
        return state

    def verify_rescaling(self, n: int = 1000, rtol: float = 1e-08, atol: float = 1e-08) -> None:
        """Check that :meth:`rescale` and :meth:`inverse_rescale` invert
        each other, Jacobians included."""
        from ..utils.testing import assert_structured_arrays_equal

        x_in = self.model.sample_unit_hypercube(n)
        x_prime, log_j = self.rescale(x_in)
        x_re, log_j_inv = self.inverse_rescale(x_prime)
        try:
            assert_structured_arrays_equal(x_re, x_in, atol=atol, rtol=rtol)
        except AssertionError as e:
            raise RuntimeError(f"Rescaling is not invertible. Error: {e}")
        if not np.allclose(log_j, -log_j_inv, rtol=rtol, atol=atol):
            raise RuntimeError("Forward and inverse Jacobian determinants are not equal")

    # ------------------------------------------------------------------
    # Unit hypercube <-> prime (logit) space
    # ------------------------------------------------------------------
    def to_prime(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``[n, d]`` hypercube -> prime space, with log|dx'/dx|."""
        if self.reparameterisation == "logit":
            x_prime, log_j = logit(x, eps=global_config.general.eps)
            return x_prime, log_j.sum(axis=-1)
        return x.copy(), np.zeros(len(x))

    def from_prime(self, x_prime: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Prime space -> hypercube, with log|dx/dx'|."""
        if self.reparameterisation == "logit":
            x, log_j = sigmoid(x_prime)
            return x, log_j.sum(axis=-1)
        return x_prime.copy(), np.zeros(len(x_prime))

    def rescale(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """Structured hypercube samples -> prime array and log_j."""
        return self.to_prime(live_points_to_array(x, self.model.names))

    def inverse_rescale(self, x_prime: np.ndarray):
        arr, log_j = self.from_prime(x_prime)
        return numpy_array_to_live_points(arr, self.model.names), log_j

    # ------------------------------------------------------------------
    def get_proposal_log_prob(self, it: int):
        """The log-density in prime space (no Jacobian) of the proposal of
        level ``it`` (-1: the prior), as a function of ``x_prime``."""
        if it == -1:
            return lambda x_prime: np.zeros(x_prime.shape[0])
        if it < self.flow.n_models:
            return lambda x_prime: self.flow.log_prob_ith(x_prime, it)
        raise ValueError(f"No proposal for iteration {it}")

    def compute_kl_between_proposals(
        self, x: np.ndarray, p_it: Optional[int] = None, q_it: Optional[int] = None
    ) -> float:
        """Monte-Carlo KL divergence between the proposals of levels
        ``p_it`` and ``q_it`` (by default the newest and the one before)
        on structured hypercube samples ``x`` drawn from ``p``. The prior
        lives in the hypercube, so its density takes no Jacobian."""
        x_prime, log_j = self.rescale(x)
        if p_it is None:
            p_it = self.flow.n_models - 1
        if q_it is None:
            q_it = self.flow.n_models - 2
        if p_it == q_it:
            raise ValueError("p and q must be different")
        if p_it < -1 or q_it < -1:
            raise ValueError(f"Invalid p_it or q_it: {p_it}, {q_it}")
        log_p = self.get_proposal_log_prob(p_it)(x_prime)
        log_q = self.get_proposal_log_prob(q_it)(x_prime)
        if p_it > -1:
            log_p = log_p + log_j
        if q_it > -1:
            log_q = log_q + log_j
        kl = float(np.mean(log_p - log_q))
        logger.info("KL between %s and %s is: %.3g", p_it, q_it, kl)
        return kl

    # ------------------------------------------------------------------
    def train(self, samples: np.ndarray, plot: bool = False, weights: Optional[np.ndarray] = None) -> None:
        """Train the next level's flow on ``samples``. Weights that are
        passed in are normalised to sum to one; otherwise, with
        ``weighted_kl``, the weights are the samples' normalised
        importance weights ``exp(logW)``; else the training is
        unweighted. With ``plot`` the training data and draws from the
        trained level are plotted into ``output/level_<i>/``."""
        self.level_count += 1
        self._weights[self.level_count] = np.nan
        x_prime, _ = self.rescale(samples)
        level_output = os.path.join(self.output, f"level_{self.level_count}", "")
        if plot:
            from ..plot import plot_1d_comparison, plot_live_points

            os.makedirs(level_output, exist_ok=True)
            plot_live_points(samples, filename=os.path.join(level_output, "training_data.png"))
            plot_1d_comparison(
                numpy_array_to_live_points(x_prime, self.model.names),
                filename=os.path.join(level_output, "prime_training_data.png"),
            )
        if self.weighted_kl or weights is not None:
            if weights is not None:
                weights = np.asarray(weights, dtype=float)
                weights = weights / np.sum(weights)
            else:
                log_w = np.asarray(samples["logW"], dtype=float).copy()
                log_w -= logsumexp(log_w)
                weights = np.exp(log_w)
            if np.isnan(weights).any():
                raise ValueError("Weights contain NaN(s)")
            if not np.isfinite(weights).all():
                raise ValueError("Weights contain Inf(s)")
        self.flow.add_new_flow(reset=self._reset_flow)
        logger.debug("Training level %d with %d samples", self.level_count, len(x_prime))
        self.flow.train(x_prime, weights=weights)
        self.training_count += 1
        if plot:
            from ..plot import plot_live_points

            test_prime, log_prob = self.flow.sample_and_log_prob_ith(self.flow.n_models - 1, N=2000)
            test_samples, log_j_inv = self.inverse_rescale(test_prime)
            test_samples["logQ"] = log_prob - log_j_inv
            plot_live_points(test_samples, filename=os.path.join(level_output, "generated_samples.png"))

    # ------------------------------------------------------------------
    def compute_log_Q(
        self, x_prime: np.ndarray, log_j: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Meta-proposal density in the hypercube of prime samples.

        Returns ``(log_Q, log_q [n, n_proposals])``: column 0 is the prior
        (0), the others ``flow.log_prob(x') + log|dx'/dx|``.
        """
        if np.isnan(x_prime).any():
            logger.warning("NaNs in samples when computing log_Q")
        if any(np.isnan(w) for w in self.weights.values()):
            raise RuntimeError(f"Some weights are not set! {_UNSET_WEIGHT}")
        if self.n_proposals > 1 and log_j is None:
            raise RuntimeError("Must specify log_j! Meta-proposal includes flows")
        log_q_all = np.zeros((len(x_prime), self.n_proposals))
        if self.flow.n_models >= 1:
            log_q_all[:, 1:] = self.flow.log_prob_all(x_prime) + log_j[:, None]
        if np.isnan(log_q_all).any():
            raise ValueError("log_q contains NaNs")
        log_Q = logsumexp(log_q_all, b=self.weights_array[None, :], axis=1)
        return log_Q, log_q_all

    def compute_meta_proposal_from_log_q(self, log_q: np.ndarray) -> np.ndarray:
        return logsumexp(log_q, b=self.weights_array[None, :], axis=1)

    def compute_meta_proposal_samples(self, samples) -> Tuple[np.ndarray, np.ndarray]:
        """Meta-proposal density of structured hypercube samples."""
        if self.level_count not in self.weights or np.isnan(self.weights[self.level_count]):
            raise RuntimeError(f"Weight(s) missing or not set. Current weights: {self.weights}.")
        x_prime, log_j = self.rescale(samples)
        return self.compute_log_Q(x_prime, log_j=log_j)

    # ------------------------------------------------------------------
    def draw(self, n: int, flow_number: Optional[int] = None):
        """Draw ``n`` hypercube samples from a level's flow (the newest by
        default), keep those inside the open hypercube with a finite
        meta-proposal density, and return them with their ``log_q``
        rows ``[n, n_proposals]``."""
        if flow_number is None:
            flow_number = self.flow.n_models - 1
        samples = empty_structured_array(0, names=self.model.names)
        log_q = np.empty((0, self.n_proposals))
        n_accepted = 0
        n_draws = 0
        while n_accepted < n:
            prime, _ = self.flow.sample_and_log_prob_ith(flow_number, N=n)
            n_draws += n
            x_arr, _ = self.from_prime(prime)
            finite = (
                np.isfinite(prime).all(axis=1)
                & np.isfinite(x_arr).all(axis=1)
                & (x_arr > 0.0).all(axis=1)
                & (x_arr < 1.0).all(axis=1)
            )
            prime = prime[finite]
            if not len(prime):
                if n_draws > 100 * n:
                    raise RuntimeError("Failed to draw finite samples")
                continue
            # log|dx'/dx| = -log|dx/dx'|
            _, log_j_from = self.from_prime(prime)
            log_Q_batch, log_q_batch = self.compute_log_Q(prime, log_j=-log_j_from)
            ok = np.isfinite(log_Q_batch)
            x_batch, _ = self.from_prime(prime[ok])
            new = numpy_array_to_live_points(x_batch, self.model.names)
            new["logQ"] = log_Q_batch[ok]
            new["logU"] = self.model.batch_evaluate_log_prior_unit_hypercube(new)
            new["logW"] = new["logU"] - new["logQ"]
            samples = np.concatenate([samples, new])
            log_q = np.concatenate([log_q, log_q_batch[ok]])
            n_accepted += len(new)
            if n_draws > 100 * n:
                logger.warning("Drawing is very inefficient")
                break
        return samples[:n], log_q[:n]

    def update_log_q(self, samples: np.ndarray, log_q: np.ndarray) -> np.ndarray:
        """Append the newest level's ``log_q`` column for ``samples``."""
        if log_q.shape[1] == self.n_proposals:
            raise ValueError("log_q array already contains current proposal")
        x_prime, log_j = self.rescale(samples)
        new_col = self.flow.log_prob_ith(x_prime, self.level_count) + log_j
        return np.concatenate([log_q, new_col[:, None]], axis=1)

    def draw_from_prior(self, n: int):
        """Prior draws (through the model) with their ``log_q`` matrix."""
        samples = self.model.sample_unit_hypercube(n)
        samples["logU"] = self.model.batch_evaluate_log_prior_unit_hypercube(samples)
        x_prime, log_j = self.rescale(samples)
        log_Q, log_q = self.compute_log_Q(x_prime, log_j=log_j)
        samples["logQ"] = log_Q
        samples["logW"] = samples["logU"] - log_Q
        return samples, log_q

    def draw_from_flows(self, n: int, weights: Optional[np.ndarray] = None, counts=None):
        """Draw ``n`` samples from the whole mixture: a multinomial count
        per proposal (``counts`` where given), prior draws for the prior
        and level draws for the flows."""
        if weights is None:
            weights = self.weights_array
        weights = np.asarray(weights, dtype=float)
        if np.isnan(weights).any():
            raise RuntimeError(f"Cannot draw from the meta-proposal: {_UNSET_WEIGHT}")
        weights = weights / weights.sum()
        if counts is None:
            counts = self.rng.multinomial(n, weights)
        all_prime = []
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if i == 0:
                u = self.rng.uniform(size=(int(c), self.model.dims))
                prime, _ = self.to_prime(u)
            else:
                prime, _ = self.flow.sample_and_log_prob_ith(i - 1, N=int(c))
            all_prime.append(prime)
        prime = np.concatenate(all_prime, axis=0)
        x_arr, _ = self.from_prime(prime)
        finite = (
            np.isfinite(x_arr).all(axis=1) & (x_arr > 0).all(axis=1) & (x_arr < 1).all(axis=1)
        )
        prime = prime[finite]
        x_arr = x_arr[finite]
        _, log_j = self.to_prime(x_arr)
        log_Q, log_q = self.compute_log_Q(prime, log_j)
        samples = numpy_array_to_live_points(x_arr, self.model.names)
        samples["logQ"] = log_Q
        samples["logU"] = 0.0
        samples["logW"] = -log_Q
        return samples, log_q
