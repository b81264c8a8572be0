"""Importance nested sampler (i-nessai, arXiv:2302.08526). Counterpart of
``nessai_tpu/samplers/importancesampler.py``.

The sampler keeps every sample, sorted by log-likelihood, in
:class:`OrderedSamples` with its ``[n, levels + 1]`` matrix of proposal
log-densities. Each level raises the likelihood threshold (entropy or
quantile rule on the live points' weights), trains a new flow on the
samples above it, draws ``nlive`` new samples from that flow and
re-weights every stored sample under the grown meta-proposal. The
evidence is the Monte-Carlo mean of ``exp(logL + logW)``. The loop and
its bookkeeping run on the host in float64; the flows train and run on
the proposal's device.
"""

import datetime
import logging
import os
from typing import Any, Callable, Literal, Optional

import numpy as np
from scipy.special import logsumexp

from ..evidence import _INSIntegralState, log_evidence_from_ins_samples
from ..livepoint import add_extra_parameters_to_live_points
from ..posterior import draw_posterior_samples as _draw_posterior_samples
from ..proposal.importance import ImportanceFlowProposal
from ..stopping_criteria import CriterionGroup, StoppingCriterionRegistry
from ..utils.information import differential_entropy
from ..utils.optimise import optimise_meta_proposal_weights
from ..utils.stats import effective_sample_size, weighted_quantile
from ..utils.structures import get_subset_arrays
from .base import BaseNestedSampler

logger = logging.getLogger(__name__)

__all__ = ["OrderedSamples", "ImportanceNestedSampler"]


class OrderedSamples:
    """logL-sorted sample store with its live/nested split and the
    ``[n, n_proposals]`` log_q matrix. With ``replace_all`` every live
    point moves to the nested set at each level. A pickle holds the
    log_q matrix only with ``save_log_q``; otherwise it is recomputed
    through the flows at resume."""

    def __init__(self, strict_threshold: bool = False, replace_all: bool = False, save_log_q: bool = False):
        self.samples = None
        self.log_q = None
        #: True where a sample has been moved to the nested set
        self.is_nested = None
        self.strict_threshold = strict_threshold
        self.replace_all = replace_all
        self.save_log_q = save_log_q
        self.log_likelihood_threshold = -np.inf
        self.state = _INSIntegralState()
        self._live_points_cleared = False

    @property
    def live_points(self):
        if self.samples is None or self._live_points_cleared:
            return None
        return self.samples[~self.is_nested]

    @live_points.setter
    def live_points(self, value):
        """Only ``None`` is accepted: moves every sample to the nested
        set."""
        if value is not None:
            raise ValueError("Can only set live points to None!")
        if self.is_nested is not None:
            self.is_nested[:] = True
        self._live_points_cleared = True

    @property
    def nested_samples(self):
        if self.samples is None:
            return None
        return self.samples[self.is_nested]

    @property
    def live_points_indices(self):
        if self.samples is None or self._live_points_cleared:
            return None
        return np.where(~self.is_nested)[0]

    @property
    def nested_samples_indices(self):
        if self.samples is None:
            return np.empty(0, dtype=int)
        return np.where(self.is_nested)[0]

    def sort_samples(self, samples, *args):
        """Sort samples (and any extra aligned arrays) by ``logL``."""
        idx = np.argsort(samples, order="logL")
        if args:
            return get_subset_arrays(idx, samples, *args)
        return samples[idx]

    def add_initial_samples(self, samples, log_q) -> None:
        self.samples, self.log_q = self.sort_samples(samples, log_q)
        self.is_nested = np.zeros(len(samples), dtype=bool)
        self._live_points_cleared = False

    def add_samples(self, samples, log_q) -> None:
        """Merge new samples keeping the global logL order. With
        ``strict_threshold`` every sample is split again on the current
        threshold; otherwise all new samples are live."""
        new_nested = np.zeros(len(samples), dtype=bool)
        all_samples = np.concatenate([self.samples, samples])
        all_log_q = np.concatenate([self.log_q, log_q], axis=0)
        all_nested = np.concatenate([self.is_nested, new_nested])
        order = np.argsort(all_samples, order="logL")
        self.samples = all_samples[order]
        self.log_q = all_log_q[order]
        if self.strict_threshold:
            self.is_nested = self.samples["logL"] < self.log_likelihood_threshold
        else:
            self.is_nested = all_nested[order]
        self._live_points_cleared = False

    def update_log_likelihood_threshold(self, threshold: float) -> None:
        self.log_likelihood_threshold = float(threshold)

    def add_to_nested_samples(self, indices) -> None:
        """Move the given sample indices from the live to the nested set."""
        self.is_nested[np.asarray(indices, dtype=int)] = True

    def remove_samples(self) -> int:
        """Move the live points below the threshold (every live point with
        ``replace_all``) into the nested set; returns how many moved."""
        if self.replace_all:
            n_removed = int((~self.is_nested).sum())
            self.is_nested[:] = True
            self._live_points_cleared = True
            return n_removed
        to_nest = (~self.is_nested) & (self.samples["logL"] < self.log_likelihood_threshold)
        n_removed = int(to_nest.sum())
        self.is_nested |= to_nest
        return n_removed

    def update_evidence(self) -> None:
        self.state.update_evidence(self.nested_samples, live_points=self.live_points)

    def finalise(self) -> None:
        self.live_points = None
        self.state.update_evidence(self.samples, live_points=None)

    def compute_importance(self, importance_ratio: float = 0.5) -> dict:
        """Relative importance of each proposal level: ``total``,
        ``posterior`` and ``evidence`` arrays over the proposals (the
        first is the prior)."""
        n_proposals = self.log_q.shape[1]
        log_imp_post = np.full(n_proposals, -np.inf)
        log_imp_z = np.full(n_proposals, -np.inf)
        log_w = self.samples["logL"] + self.samples["logW"]
        its = self.samples["it"]
        for i, it in enumerate(range(-1, n_proposals - 1)):
            sidx = its == it
            zidx = its >= it
            n_s = int(sidx.sum())
            n_z = int(zidx.sum())
            if n_s:
                log_imp_post[i] = logsumexp(log_w[sidx]) - np.log(n_s)
            if n_z:
                log_imp_z[i] = logsumexp(log_w[zidx]) - np.log(n_z)
        imp_z = np.exp(log_imp_z - logsumexp(log_imp_z))
        imp_post = np.exp(log_imp_post - logsumexp(log_imp_post))
        imp = (1 - importance_ratio) * imp_z + importance_ratio * imp_post
        return {"total": imp, "posterior": imp_post, "evidence": imp_z}

    def compute_evidence_ratio(self, threshold: Optional[float] = None) -> float:
        """Log-ratio of the evidence above ``threshold`` to the total."""
        if threshold is None:
            threshold = self.log_likelihood_threshold
        above = self.samples["logL"] >= threshold
        return log_evidence_from_ins_samples(self.samples[above]) - self.state.log_evidence

    def __getstate__(self):
        state = dict(self.__dict__)
        if not self.save_log_q:
            state["log_q"] = None
        return state


class ImportanceNestedSampler(BaseNestedSampler):
    """The importance nested sampler.

    ``device`` (default CUDA) is where the flows train and run; further
    keyword arguments go to the proposal (``ImportanceFlowProposal``), as
    in the JAX package: ``mesh`` among them, the device mesh its levels
    train and run on. The sampling loop runs on the host in float64. It checkpoints only at
    the end of a level (:meth:`checkpoint`).
    """

    #: compat names of criteria whose canonical name is not a state attribute
    _CRITERION_ATTRS = {
        "ratio": "log_evidence_ratio",
        "ratio_ns": "log_evidence_ratio_nested_samples",
        "Z_err": "evidence_error",
        "dlogZ": "difference_log_evidence",
    }

    def __init__(
        self,
        model,
        nlive: int = 5000,
        n_initial: Optional[int] = None,
        output: Optional[str] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        checkpointing: bool = True,
        checkpoint_interval: int = 600,
        checkpoint_on_iteration: bool = False,
        checkpoint_callback: Optional[Callable] = None,
        save_log_q: bool = False,
        logging_interval: Optional[int] = None,
        log_on_iteration: bool = True,
        resume_file: Optional[str] = None,
        plot: bool = True,
        plotting_frequency: int = 5,
        min_iteration: Optional[int] = None,
        max_iteration: Optional[int] = None,
        min_samples: int = 500,
        min_remove: int = 1,
        max_samples: Optional[int] = None,
        stopping_criterion="ratio",
        tolerance=0.0,
        n_update: Optional[int] = None,
        plot_pool: bool = False,
        plot_trace: bool = True,
        plot_likelihood_levels: bool = True,
        plot_level_cdf: bool = False,
        plot_training_data: bool = False,
        plot_extra_state: bool = False,
        trace_plot_kwargs: Optional[dict] = None,
        save_existing_checkpoint: bool = False,
        replace_all: bool = False,
        threshold_method: Literal["entropy", "quantile"] = "entropy",
        threshold_kwargs: Optional[dict] = None,
        n_pool: Optional[int] = None,
        pool: Optional[Any] = None,
        check_criteria: Literal["any", "all"] = "any",
        weighted_kl: bool = False,
        draw_constant: bool = True,
        train_final_flow: bool = False,
        bootstrap: bool = False,
        close_pool: bool = False,
        strict_threshold: bool = False,
        draw_iid_live: bool = True,
        flow_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        reset_flow=True,
        reparameterisation: Optional[str] = "logit",
        device=None,
        **kwargs,
    ):
        self.add_fields()
        super().__init__(
            model,
            nlive,
            output=output,
            seed=seed,
            rng=rng,
            checkpointing=checkpointing,
            checkpoint_interval=checkpoint_interval,
            checkpoint_on_iteration=checkpoint_on_iteration,
            checkpoint_callback=checkpoint_callback,
            logging_interval=logging_interval,
            log_on_iteration=log_on_iteration,
            resume_file=resume_file,
            plot=plot,
            n_pool=n_pool,
            pool=pool,
            device=device,
        )
        # the flag shadows the method on the instance, as in the JAX
        # package; FlowSampler closes the pool through the model
        self.close_pool = close_pool
        self.save_log_q = save_log_q
        self.plotting_frequency = plotting_frequency
        self._plot_pool = plot_pool
        self._plot_trace = plot_trace
        self._plot_likelihood_levels = plot_likelihood_levels
        self._plot_level_cdf = plot_level_cdf
        self.plot_training_data = plot_training_data
        self._plot_extra_state = plot_extra_state
        self.trace_plot_kwargs = {} if trace_plot_kwargs is None else dict(trace_plot_kwargs)
        #: keep the previous resume file as ``.old`` at each checkpoint
        #: (off by default: INS resume files can be large)
        self.save_existing_checkpoint = save_existing_checkpoint
        self.n_initial = n_initial or nlive
        self.configure_iterations(min_iteration=min_iteration, max_iteration=max_iteration)
        self.min_samples = min_samples
        self.min_remove = min_remove
        self.max_samples = max_samples
        self.n_update = n_update
        self.draw_constant = draw_constant
        self.replace_all = replace_all
        self.strict_threshold = strict_threshold
        self.draw_iid_live = draw_iid_live
        self.threshold_method = threshold_method
        self.threshold_kwargs = dict(threshold_kwargs or {})
        self._train_final_flow = train_final_flow
        self.bootstrap = bootstrap
        self.bootstrap_log_evidence = None
        self.bootstrap_log_evidence_error = None
        self.configure_stopping_criterion(stopping_criterion, tolerance, check_criteria)
        self.proposal = self.get_proposal(
            flow_config=flow_config,
            training_config=training_config,
            reparameterisation=reparameterisation,
            weighted_kl=weighted_kl,
            reset_flow=reset_flow,
            rng=self.rng,
            device=self.device,
            **kwargs,
        )
        self.training_samples = OrderedSamples(
            strict_threshold=strict_threshold, replace_all=replace_all, save_log_q=save_log_q
        )
        self.iid_samples = (
            OrderedSamples(strict_threshold=strict_threshold, save_log_q=save_log_q) if draw_iid_live else None
        )

        self.initialised = False
        self.log_likelihood_threshold = -np.inf
        self.logX = 0.0
        self.logL = -np.inf
        self.gradient = np.nan
        self.criterion = {}
        self.importance = dict(total=None, posterior=None, evidence=None)
        self.sample_counts = {}
        self.live_points_ess = np.nan
        self._current_proposal_entropy = np.nan
        self._final_samples_unit = None
        self.final_log_w = None
        self._final_state = None
        self.check_configuration()
        self.training_time = datetime.timedelta()
        self.draw_samples_time = datetime.timedelta()
        self.add_and_update_samples_time = datetime.timedelta()
        #: time in ``ImportanceFlowProposal.update_log_q`` (the new level's
        #: log-density over every stored sample)
        self.update_log_q_time = datetime.timedelta()
        #: time in :meth:`draw_final_samples`
        self.draw_final_samples_time = datetime.timedelta()

    def check_configuration(self) -> bool:
        """Check ``min_samples`` and ``min_remove`` against ``nlive``."""
        if self.min_samples > self.nlive:
            raise ValueError("`min_samples` must be less than `nlive`")
        if self.min_remove > self.nlive:
            raise ValueError("`min_remove` must be less than `nlive`")
        return True

    def get_proposal(self, subdir: str = "levels", **kwargs) -> ImportanceFlowProposal:
        """The meta-proposal, writing into ``output/subdir``."""
        return ImportanceFlowProposal(self.model, output=os.path.join(self.output, subdir, ""), **kwargs)

    @staticmethod
    def sort_samples(samples, *arrays):
        """``samples`` (and arrays aligned with them) sorted by logL."""
        order = np.argsort(samples, order="logL")
        out = [samples[order]] + [a[order] for a in arrays]
        return out[0] if not arrays else tuple(out)

    # ------------------------------------------------------------------
    @staticmethod
    def add_fields() -> None:
        """Register the live-point fields logW, logQ and logU."""
        add_extra_parameters_to_live_points(["logW", "logQ", "logU"], [np.nan, np.nan, np.nan])

    def configure_stopping_criterion(self, stopping_criterion, tolerance, check_criteria) -> None:
        if isinstance(stopping_criterion, str):
            stopping_criterion = [stopping_criterion]
        if not isinstance(tolerance, (list, tuple)):
            tolerance = [tolerance]
        criteria = [
            StoppingCriterionRegistry.get(name, tolerance=tol)
            for name, tol in zip(stopping_criterion, tolerance)
        ]
        self.combined_criterion = CriterionGroup(
            criteria, mode="and" if check_criteria == "all" else "or"
        )

    # ------------------------------------------------------------------
    @property
    def _ordered_samples(self) -> OrderedSamples:
        """The main sample set: the i.i.d. samples with ``draw_iid_live``,
        else the training samples."""
        if self.draw_iid_live:
            return self.iid_samples
        return self.training_samples

    @property
    def live_points_unit(self):
        return self._ordered_samples.live_points

    @property
    def nested_samples_unit(self):
        return self._ordered_samples.nested_samples

    @property
    def samples_unit(self):
        return self._ordered_samples.samples

    @property
    def samples(self):
        """Every sample, in the model space."""
        return self.model.from_unit_hypercube(self.samples_unit)

    @property
    def live_points(self):
        """The live points in the model space (None once cleared)."""
        lp = self.live_points_unit
        if lp is None:
            return None
        return self.model.from_unit_hypercube(lp)

    @live_points.setter
    def live_points(self, samples) -> None:
        if samples is not None:
            raise RuntimeError("Cannot set live points")

    @property
    def nested_samples(self):
        """The nested samples in the model space (every sample once the
        run is finalised)."""
        ns = self.nested_samples_unit
        if ns is None or not len(ns):
            return np.empty(0)
        return self.model.from_unit_hypercube(ns)

    @property
    def state(self) -> _INSIntegralState:
        return self._ordered_samples.state

    @property
    def log_evidence(self) -> float:
        return self.state.log_evidence

    @property
    def log_evidence_error(self) -> float:
        return self.state.log_evidence_error

    @property
    def posterior_effective_sample_size(self) -> float:
        return self.state.effective_n_posterior_samples

    @property
    def posterior_samples_set(self) -> OrderedSamples:
        """The main sample set (an alias of the older name)."""
        return self._ordered_samples

    @property
    def log_q(self) -> np.ndarray:
        """The training samples' log-density under each level."""
        return self.training_samples.log_q

    @property
    def current_proposal_entropy(self) -> float:
        """The differential entropy of the newest level's last draw."""
        return getattr(self, "_current_proposal_entropy", np.nan)

    @property
    def log_posterior_weights(self) -> np.ndarray:
        return self.state.log_posterior_weights

    @property
    def reached_tolerance(self) -> bool:
        return self.combined_criterion.is_met(self.criterion)

    @property
    def stopping_criteria(self):
        return self.combined_criterion.names

    # ------------------------------------------------------------------
    def populate_live_points(self) -> None:
        """Initial prior draws in the unit hypercube (twice ``n_initial``
        with ``draw_iid_live``: half for training, half i.i.d.)."""
        target = 2 * self.n_initial if self.draw_iid_live else self.n_initial
        points = self.model.sample_unit_hypercube(target)
        points["logP"] = self.model.batch_evaluate_log_prior(points, unit_hypercube=True)
        finite = np.isfinite(points["logP"])
        while not finite.all():
            n_bad = int((~finite).sum())
            extra = self.model.sample_unit_hypercube(n_bad)
            extra["logP"] = self.model.batch_evaluate_log_prior(extra, unit_hypercube=True)
            points[np.flatnonzero(~finite)[: len(extra)]] = extra
            finite = np.isfinite(points["logP"])
        points["logL"] = self.model.batch_evaluate_log_likelihood(points, unit_hypercube=True)
        if np.any(points["logL"] == np.inf):
            raise RuntimeError("Live points contain +inf log-likelihoods")
        points["it"] = -1
        points["logQ"] = 0.0
        points["logU"] = self.model.batch_evaluate_log_prior_unit_hypercube(points)
        points["logW"] = points["logU"] - points["logQ"]
        log_q = np.zeros((target, 1))
        if self.draw_iid_live:
            self.training_samples.add_initial_samples(points[: self.n_initial], log_q[: self.n_initial])
            self.iid_samples.add_initial_samples(points[self.n_initial :], log_q[self.n_initial :])
        else:
            self.training_samples.add_initial_samples(points, log_q)
        self.sample_counts[-1] = self.n_initial

    def initialise(self) -> None:
        if self.initialised:
            return
        if self.training_samples.samples is None:
            self.populate_live_points()
        self.initialise_history()
        self.proposal.initialise()
        self.initialised = True

    # ------------------------------------------------------------------
    # Threshold determination
    # ------------------------------------------------------------------
    def determine_threshold_quantile(self, samples, q: float = 0.8, include_likelihood: bool = False) -> int:
        """Number of live points to discard: the weighted ``q`` quantile
        of their log-likelihoods."""
        a = samples["logL"]
        if include_likelihood:
            log_weights = samples["logW"] + samples["logL"]
        else:
            log_weights = samples["logW"].copy()
        cutoff = weighted_quantile(a, q, log_weights=log_weights, values_sorted=True)
        if not np.isfinite(cutoff):
            raise RuntimeError("Could not determine valid quantile")
        return int(np.argmax(a >= cutoff))

    def determine_threshold_entropy(
        self,
        samples,
        q: float = 0.5,
        include_likelihood: bool = False,
        use_log_weights: bool = True,
    ) -> int:
        """Number of live points to discard: where the cumulative
        (log-)weight reaches the fraction ``q`` of its total."""
        if include_likelihood:
            log_weights = samples["logW"] + samples["logL"]
        else:
            log_weights = samples["logW"]
        p = log_weights if use_log_weights else np.exp(log_weights)
        cdf = np.cumsum(p)
        if cdf[-1] == 0:
            cdf = np.arange(len(p), dtype=float)
        cdf = cdf / cdf[-1]
        n = int(np.argmax(cdf >= q))
        if self.plot and self._plot_level_cdf:
            self.plot_level_cdf(
                samples["logL"],
                cdf,
                threshold=float(samples["logL"][n]),
                q=q,
                filename=os.path.join(self.output, "levels", f"level_cdf_{self.iteration}.png"),
            )
        return n

    def determine_log_likelihood_threshold(self, samples, method="entropy", **kwargs) -> float:
        if method == "quantile":
            n = self.determine_threshold_quantile(samples, **kwargs)
        elif method == "entropy":
            n = self.determine_threshold_entropy(samples, **kwargs)
        else:
            raise ValueError(method)
        if n == 0:
            if self.min_remove < 1:
                return -np.inf
            n = 1
        if (samples.size - n) < self.min_samples:
            logger.warning(
                "Cannot remove %s from %s, min_samples=%s", n, samples.size, self.min_samples
            )
            n = max(0, samples.size - self.min_samples)
        elif n < self.min_remove:
            logger.warning("Cannot remove less than %s samples", self.min_remove)
            n = self.min_remove
        if (
            self.draw_constant
            and self.max_samples
            and ((samples.size - n) + self.nlive) > self.max_samples
        ):
            n = samples.size - self.max_samples + self.nlive
            logger.warning("Next level would have more than max samples, removing %s samples", n)
        return float(samples[n]["logL"])

    def update_log_likelihood_threshold(self, threshold: float) -> None:
        self.log_likelihood_threshold = threshold
        self.training_samples.update_log_likelihood_threshold(threshold)
        if self.iid_samples:
            self.iid_samples.update_log_likelihood_threshold(threshold)

    # ------------------------------------------------------------------
    # Level construction
    # ------------------------------------------------------------------
    def add_new_proposal(self) -> None:
        """Train the next level's flow on the training samples above the
        threshold (at least ``min_samples`` of them)."""
        st = datetime.datetime.now()
        n_train = min(
            int(np.argmax(self.training_samples.samples["logL"] >= self.log_likelihood_threshold)),
            self.training_samples.samples.size - self.min_samples,
        )
        training = self.training_samples.samples[n_train:]
        logger.info("Training next proposal with %d samples", len(training))
        # train() normalises the weights, their sign included
        weights = -np.exp(self.training_samples.log_q[n_train:, -1]) if self.replace_all else None
        self.proposal.train(training, plot=self.plot_training_data, weights=weights)
        self.training_time += datetime.datetime.now() - st

    def add_new_proposal_weight(self, iteration: int, n_new: int) -> None:
        if self.sample_counts.get(iteration):
            raise RuntimeError(f"Samples already drawn from proposal {iteration}")
        n_total = len(self.samples_unit) + n_new
        self.sample_counts[iteration] = n_new
        self.proposal.update_proposal_weights(
            {k: v / n_total for k, v in self.sample_counts.items()}
        )

    def draw_n_samples(self, n: int):
        st = datetime.datetime.now()
        new_points, log_q = self.proposal.draw(n)
        new_points["logL"] = self.model.batch_evaluate_log_likelihood(new_points, unit_hypercube=True)
        if np.any(new_points["logL"] == -np.inf):
            logger.warning("New points contain zero-likelihood samples")
        self.draw_samples_time += datetime.datetime.now() - st
        return new_points, log_q

    def _refresh_ordered_samples(self, ordered: OrderedSamples) -> None:
        """Add the new level's column to ``log_q`` and recompute logQ and
        logW of every stored sample."""
        st = datetime.datetime.now()
        ordered.log_q = self.proposal.update_log_q(ordered.samples, ordered.log_q)
        self.update_log_q_time += datetime.datetime.now() - st
        ordered.samples["logQ"] = self.proposal.compute_meta_proposal_from_log_q(ordered.log_q)
        ordered.samples["logW"] = ordered.samples["logU"] - ordered.samples["logQ"]

    def add_and_update_points(self, n: int) -> None:
        """Draw ``n`` new samples (and ``n`` i.i.d. ones), and update the
        stored log_q, logQ and logW."""
        st = datetime.datetime.now()
        new_samples, log_q = self.draw_n_samples(n)
        new_samples["it"] = self.iteration
        self._current_proposal_entropy = differential_entropy(-log_q[:, -1])
        self.history["leakage_new_points"].append(self.compute_leakage(new_samples))
        self.history["n_added"].append(len(new_samples))
        self._refresh_ordered_samples(self.training_samples)
        self.training_samples.add_samples(new_samples, log_q)
        if self.draw_iid_live:
            iid_samples, iid_log_q = self.draw_n_samples(n)
            iid_samples["it"] = self.iteration
            self._refresh_ordered_samples(self.iid_samples)
            self.iid_samples.add_samples(iid_samples, iid_log_q)
        self.live_points_ess = effective_sample_size(self.live_points_unit["logW"])
        self.add_and_update_samples_time += datetime.datetime.now() - st

    def add_level_post_sampling(self, samples: np.ndarray, n: int) -> None:
        """Add a level after the sampling has ended: train a flow on
        ``samples``, draw ``n`` points from it into each sample set's
        nested samples, update the evidence and count the level as an
        iteration."""
        self.proposal.train(samples)
        self.add_new_proposal_weight(self.iteration, n)
        for ordered in [self.training_samples] + ([self.iid_samples] if self.iid_samples is not None else []):
            new_samples, log_q = self.draw_n_samples(n)
            new_samples["it"] = self.iteration
            self._refresh_ordered_samples(ordered)
            ordered.add_samples(new_samples, log_q)
            ordered.add_to_nested_samples(ordered.live_points_indices)
            ordered.finalise()
        self.iteration += 1

    def remove_samples(self) -> int:
        n_removed = self.training_samples.remove_samples()
        if self.draw_iid_live:
            n_removed = self.iid_samples.remove_samples()
        self.history["n_removed"].append(n_removed)
        return n_removed

    def update_evidence(self) -> None:
        self.training_samples.update_evidence()
        if self.draw_iid_live:
            self.iid_samples.update_evidence()

    def compute_stopping_criterion(self) -> dict:
        return {
            name: getattr(self.state, self._CRITERION_ATTRS.get(name, name), None)
            for name in self.combined_criterion.names
        }

    def _compute_gradient(self) -> None:
        """The dlogL/dlogX diagnostic."""
        logX_pre, logL_pre = self.logX, self.logL
        lp = self.live_points_unit
        self.logX = logsumexp(lp["logW"]) - np.log(max(len(self.samples_unit), 1))
        self.logL = logsumexp(lp["logL"] + lp["logW"]) - logsumexp(lp["logW"])
        dX = self.logX - logX_pre
        self.gradient = (self.logL - logL_pre) / dX if dX else np.nan

    def compute_leakage(self, samples, weights: bool = True) -> float:
        """Share of the importance weight (or, with ``weights=False``, of
        the count) of ``samples`` below the current threshold."""
        below = samples["logL"] < self.log_likelihood_threshold
        if not weights:
            return float(np.mean(below))
        if not below.any():
            return 0.0
        return float(np.exp(logsumexp(samples["logW"][below]) - logsumexp(samples["logW"])))

    def samples_entropy(self) -> float:
        return differential_entropy(self.samples_unit["logQ"])

    def kl_divergence(self, samples=None) -> float:
        """KL divergence of the posterior weights from the uniform
        weights of the samples."""
        if samples is None:
            samples = self.samples_unit
        log_p = samples["logL"] + samples["logW"]
        log_p = log_p - logsumexp(log_p)
        log_q = -np.log(len(samples)) * np.ones(len(samples))
        return float(np.sum(np.exp(log_p) * (log_p - log_q)))

    def compute_importance(self, importance_ratio: float = 0.5):
        return self._ordered_samples.compute_importance(importance_ratio)

    # ------------------------------------------------------------------
    # History / logging
    # ------------------------------------------------------------------
    def initialise_history(self) -> None:
        super().initialise_history()
        self.history.update(
            dict(
                logZ=[],
                min_log_likelihood=[],
                max_log_likelihood=[],
                logL_threshold=[],
                logX=[],
                gradients=[],
                n_live=[],
                n_added=[],
                n_removed=[],
                live_points_ess=[],
                leakage_live_points=[],
                leakage_new_points=[],
                samples_entropy=[],
                proposal_entropy=[],
                stopping_criteria={k: [] for k in self.stopping_criteria},
            )
        )

    def update_history(self) -> None:
        super().update_history()
        lp = self.live_points_unit
        self.history["logZ"].append(self.state.log_evidence)
        self.history["min_log_likelihood"].append(float(np.min(lp["logL"])))
        self.history["max_log_likelihood"].append(float(np.max(lp["logL"])))
        self.history["logL_threshold"].append(self.log_likelihood_threshold)
        self.history["logX"].append(self.logX)
        self.history["gradients"].append(self.gradient)
        self.history["n_live"].append(len(lp))
        self.history["live_points_ess"].append(self.live_points_ess)
        self.history["leakage_live_points"].append(self.compute_leakage(lp))
        self.history["samples_entropy"].append(self.samples_entropy())
        self.history["proposal_entropy"].append(self._current_proposal_entropy)
        for k, v in self.criterion.items():
            self.history["stopping_criteria"][k].append(v)

    def log_state(self) -> None:
        lp = self.live_points_unit
        logger.info(
            "Update %d - log Z: %.3f +/- %.3f ESS: %.1f logL min: %.3f median: %.3f max: %.3f",
            self.iteration,
            self.state.log_evidence,
            self.state.log_evidence_error,
            self.state.effective_n_posterior_samples,
            lp["logL"].min(),
            float(np.nanmedian(lp["logL"])),
            lp["logL"].max(),
        )

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------
    def checkpoint(self, periodic: bool = False, force: bool = False):
        """Only the end of a level is a valid checkpoint (the sample
        store and its log_q matrix change within a level): a checkpoint
        that is not periodic, such as one from a signal, is refused with
        a warning, as in the JAX package."""
        if periodic is False:
            logger.warning("Importance Sampler cannot checkpoint mid iteration")
            return
        super().checkpoint(periodic=periodic, force=force)

    def nested_sampling_loop(self):
        """Add levels until the stopping criterion is met (or
        ``max_iteration``), then finalise. Returns ``(logZ, samples)``
        with every sample in the unit hypercube (:attr:`samples_unit`)."""
        if self.finalised:
            logger.warning("Sampler has already finished sampling")
            return self.log_evidence, self.samples_unit
        self.initialise()
        self.sampling_start_time = datetime.datetime.now()
        while True:
            if self.reached_tolerance and self.iteration >= self.min_iteration:
                break
            self._compute_gradient()
            if self.n_update is None:
                threshold = self.determine_log_likelihood_threshold(
                    self.live_points_unit, method=self.threshold_method, **self.threshold_kwargs
                )
            else:
                threshold = float(self.live_points_unit[self.n_update]["logL"])
            self.update_log_likelihood_threshold(threshold)
            n_removed = self.remove_samples()
            self.add_new_proposal()
            n_add = self.nlive if (self.draw_constant or self.replace_all) else n_removed
            self.add_new_proposal_weight(self.iteration, n_add)
            self.add_and_update_points(n_add)
            self.update_evidence()
            self.importance = self.compute_importance()
            self.criterion = self.compute_stopping_criterion()
            self.log_state()
            self.update_history()
            self.iteration += 1
            if not self.iteration % self.plotting_frequency:
                self.produce_plots()
            if self.checkpointing:
                self.checkpoint(periodic=True)
            if self.iteration >= self.max_iteration:
                logger.warning("Reached max iteration")
                break
        logger.info("Finished INS loop after %d iterations with %s", self.iteration, self.criterion)
        self.finalise()
        self.sampling_time += datetime.datetime.now() - self.sampling_start_time
        self.sampling_start_time = datetime.datetime.now()
        return self.log_evidence, self.samples_unit

    def finalise(self) -> None:
        """Train the final flow (``train_final_flow``), move every sample
        to the nested set and compute the final evidence, then bootstrap
        its error (``bootstrap``)."""
        if self.finalised:
            return
        if self._train_final_flow:
            self.train_final_flow()
        self.training_samples.finalise()
        if self.draw_iid_live:
            self.iid_samples.finalise()
        if self.bootstrap:
            self.adjust_final_samples()
        logger.info("Final KL divergence: %.3f", self.kl_divergence())
        logger.info(
            "Final log Z: %.3f +/- %.3f (ESS %.1f; %d proposal levels)",
            self.state.log_evidence,
            self.state.log_evidence_error,
            self.state.effective_n_posterior_samples,
            self.proposal.n_proposals,
        )
        # heavy-tailed weights (a meta-proposal that under-fits the
        # posterior) bias logZ low and the error with it; a collapsed
        # final ESS is the symptom
        ess = float(self.state.effective_n_posterior_samples)
        n_total = len(self.samples_unit)
        if n_total and (ess < 100 or ess < 0.01 * n_total):
            logger.warning(
                "Final effective sample size is very low (ESS %.1f from %d samples): "
                "the meta-proposal likely under-fits the posterior, so the evidence "
                "may be biased low and its error underestimated. Increase the flow "
                "capacity (flow_config: n_blocks/n_neurons/n_layers) and re-run.",
                ess,
                n_total,
            )
        self.finalised = True
        if self.checkpointing:
            self.checkpoint(periodic=True, force=True)

    def configure_iterations(self, min_iteration=None, max_iteration=None) -> None:
        """Set the least and the most levels (None: no limit)."""
        self.min_iteration = -1 if min_iteration is None else int(min_iteration)
        self.max_iteration = np.inf if max_iteration is None else int(max_iteration)

    def update_output(self, output: str) -> None:
        """Move the output directory, with the proposal's levels, into
        ``output``."""
        super().update_output(output)
        if self.proposal is not None:
            subdir = os.path.basename(os.path.normpath(self.proposal.output))
            self.proposal.update_output(os.path.join(output, subdir, ""))

    # ------------------------------------------------------------------
    def update_sample_counts(self) -> None:
        """Recompute the per-proposal sample counts from the stored
        samples."""
        counts = np.bincount(
            np.asarray(self.samples_unit["it"], dtype=int) + 1,
            minlength=self.proposal.n_proposals,
        )
        self.sample_counts = {it - 1: int(c) for it, c in enumerate(counts)}

    def update_proposal_weights(self) -> None:
        n_total = len(self.samples_unit)
        self.proposal.update_proposal_weights(
            {k: v / n_total for k, v in self.sample_counts.items()}
        )

    def draw_more_nested_samples(self, n: int):
        """Draw ``n`` more samples from the whole meta-proposal into the
        nested set of the training samples."""
        samples, log_q = self.proposal.draw_from_flows(n)
        samples["logL"] = self.model.batch_evaluate_log_likelihood(samples, unit_hypercube=True)
        samples["it"] = -2
        self.training_samples.add_samples(samples, log_q)
        self.training_samples.is_nested[:] = True
        self.update_evidence()
        return samples

    # ------------------------------------------------------------------
    # Final redraw, bootstrap and final flow
    # ------------------------------------------------------------------
    @property
    def final_state(self) -> Optional[_INSIntegralState]:
        """Evidence state of the redrawn samples (None before
        :meth:`draw_final_samples`)."""
        return self._final_state

    @property
    def final_log_evidence(self) -> Optional[float]:
        if self._final_state is None:
            return None
        return self._final_state.log_evidence

    @property
    def final_log_evidence_error(self) -> Optional[float]:
        """Standard error of the mean of the redrawn weights over their
        mean, in long double."""
        if self.final_log_w is None:
            return None
        n = len(self.final_log_w)
        u = np.exp(np.asarray(self.final_log_w, dtype=np.longdouble))
        z = u.mean()
        return float(np.sqrt(((u - z) ** 2).sum() / (n * (n - 1))) / z)

    @property
    def final_log_posterior_weights(self) -> Optional[np.ndarray]:
        if self.final_state:
            return self.final_state.log_posterior_weights
        return None

    @property
    def final_samples_unit(self) -> Optional[np.ndarray]:
        """The redrawn samples in the unit hypercube."""
        return self._final_samples_unit

    @property
    def final_samples(self) -> Optional[np.ndarray]:
        """The redrawn samples in the model space."""
        if self._final_samples_unit is None:
            return None
        return self.model.from_unit_hypercube(self._final_samples_unit)

    def draw_final_samples(
        self,
        n_post: Optional[int] = None,
        n_draw: Optional[int] = None,
        max_its: int = 100,
        max_batch_size: int = 20_000,
        max_samples_ratio: Optional[float] = 1.0,
        use_counts: bool = False,
        optimise_weights: bool = False,
        optimise_kwargs: Optional[dict] = None,
        optimisation_method: str = "kl",
    ):
        """Redraw from the whole meta-proposal, in batches, until the
        posterior ESS reaches ``n_post`` (by default the run's ESS) or
        ``n_draw`` samples are drawn. ``max_samples_ratio`` caps the
        redraw at that multiple of the run's samples. With
        ``optimise_weights`` the level weights are first optimised
        (``optimisation_method="kl"``; ``"evidence"`` keeps them).
        ``use_counts`` is accepted and unused, as in the JAX package.
        Returns the redrawn samples (unit hypercube)."""
        st = datetime.datetime.now()
        if n_post and n_draw:
            raise RuntimeError("Specify at most one of n_post / n_draw")
        if not n_post and not n_draw:
            n_post = int(self.state.effective_n_posterior_samples)
        max_samples = int(max_samples_ratio * len(self.samples_unit)) if max_samples_ratio else None

        weights = self.proposal.weights_array.copy()
        if optimise_weights:
            if optimisation_method == "kl":
                weights = optimise_meta_proposal_weights(
                    self.samples_unit["logL"],
                    self.training_samples.log_q,
                    weights,
                    **(optimise_kwargs or {}),
                )
            elif optimisation_method != "evidence":
                raise ValueError(optimisation_method)

        batch = min(max_batch_size, n_draw if n_draw else max(2 * n_post, 1000))
        samples = None
        for _ in range(max_its):
            new, _ = self.proposal.draw_from_flows(batch, weights=weights)
            new["logL"] = self.model.batch_evaluate_log_likelihood(new, unit_hypercube=True)
            new["it"] = -2
            samples = new if samples is None else np.concatenate([samples, new])
            ess = effective_sample_size(samples["logL"] + samples["logW"])
            if n_draw and len(samples) >= n_draw:
                break
            if n_post and ess >= n_post:
                break
            if max_samples is not None and len(samples) > max_samples:
                logger.warning("Reached maximum number of redraw samples: %d", max_samples)
                break
        else:
            logger.warning("Failed to reach target ESS in %d batches", max_its)
        self._final_samples_unit = samples
        self.final_log_w = samples["logL"] + samples["logW"]
        self._final_state = _INSIntegralState()
        self._final_state.update_evidence(samples, live_points=None)
        self.draw_final_samples_time += datetime.datetime.now() - st
        logger.info(
            "Redraw: %d samples, ESS %.1f, logZ %.3f",
            len(samples),
            effective_sample_size(self.final_log_w),
            self.final_log_evidence,
        )
        return samples

    def adjust_final_samples(self, n_batches: int = 5) -> None:
        """Bootstrap the evidence: ``n_batches`` draws of as many samples
        as the run holds, with multinomial counts per proposal, give
        :attr:`bootstrap_log_evidence` (their mean) and
        :attr:`bootstrap_log_evidence_error` (their spread)."""
        log_evidences = []
        counts_orig = np.array(
            [self.sample_counts.get(k, 0) for k in range(-1, self.proposal.level_count + 1)]
        )
        n = counts_orig.sum()
        for _ in range(n_batches):
            p = counts_orig / counts_orig.sum()
            counts = self.rng.multinomial(n, p)
            samples, _ = self.proposal.draw_from_flows(n, counts=counts)
            samples["logL"] = self.model.batch_evaluate_log_likelihood(samples, unit_hypercube=True)
            log_w = samples["logL"] + samples["logW"]
            log_evidences.append(logsumexp(log_w) - np.log(len(samples)))
        self.bootstrap_log_evidence = float(np.mean(log_evidences))
        self.bootstrap_log_evidence_error = float(np.std(log_evidences))
        logger.info(
            "Bootstrap logZ: %.3f +/- %.3f",
            self.bootstrap_log_evidence,
            self.bootstrap_log_evidence_error,
        )

    def train_final_flow(self) -> None:
        """Train one more level on every sample, weighted by its posterior
        weight. Nothing sets the new level's weight (see
        :meth:`ImportanceFlowProposal.draw_from_flows`)."""
        log_w = self.samples_unit["logL"] + self.samples_unit["logW"]
        log_w = log_w - logsumexp(log_w)
        self.proposal.train(self.samples_unit, weights=np.exp(log_w))

    def draw_posterior_samples(
        self,
        sampling_method: str = "importance_sampling",
        n: Optional[int] = None,
        use_final_samples: bool = True,
    ):
        """Posterior samples in the model space: from the redrawn samples
        where a redraw has run (and ``use_final_samples``), else from the
        main sample set, with their importance weights."""
        if use_final_samples and self.final_samples_unit is not None:
            samples = self.final_samples_unit
            log_w = self.final_log_w
        else:
            samples = self._ordered_samples.samples
            log_w = samples["logL"] + samples["logW"]
        post = _draw_posterior_samples(
            samples, log_w=log_w - logsumexp(log_w), method=sampling_method, n=n, rng=self.rng
        )
        return self.model.from_unit_hypercube(post)

    # ------------------------------------------------------------------
    # Plots (need matplotlib; the periodic ones log a failure and go on)
    # ------------------------------------------------------------------
    def plot_likelihood_levels(self, filename: Optional[str] = None, cmap: str = "viridis", max_bins: int = 50):
        """Each level's log-likelihood distribution: the whole range and
        a panel zoomed to the last level."""
        try:
            import matplotlib.pyplot as plt

            from ..utils.hist import auto_bins

            s = self.samples_unit
            its = np.unique(s["it"])
            colours = plt.get_cmap(cmap)(np.linspace(0, 1, len(its)))
            finite = np.isfinite(s["logL"])
            vmax = np.max(s["logL"][finite])
            last = (s["it"] == its[-1]) & finite
            vmin = np.min(s["logL"][last]) if last.any() else None

            fig, axs = plt.subplots(1, 2, figsize=(10, 4))
            for it, c in zip(its, colours):
                vals = s["logL"][s["it"] == it]
                vals = vals[np.isfinite(vals)]
                if not len(vals):
                    continue
                bins = auto_bins(vals, max_bins=max_bins)
                for ax in axs:
                    ax.hist(vals, bins, histtype="step", color=c, density=True)
                    ax.set_xlabel("Log-likelihood")
            axs[0].set_ylabel("Density")
            if vmin is not None:
                axs[1].set_xlim(vmin, vmax)
            fig.tight_layout()
            if filename:
                fig.savefig(filename, bbox_inches="tight")
                plt.close(fig)
                return None
            return fig
        except Exception as e:
            logger.warning("Could not plot likelihood levels: %s", e)

    def plot_level_cdf(
        self,
        log_likelihood_values: np.ndarray,
        cdf: np.ndarray,
        threshold: float,
        q: float,
        filename: Optional[str] = None,
    ):
        """The CDF that set the next threshold."""
        try:
            import matplotlib.pyplot as plt

            fig = plt.figure()
            plt.plot(log_likelihood_values, cdf)
            plt.xlabel("Log-likelihood")
            plt.title("CDF")
            plt.axhline(q, c="C1")
            plt.axvline(threshold, c="C1")
            if filename:
                os.makedirs(os.path.dirname(filename), exist_ok=True)
                fig.savefig(filename, bbox_inches="tight")
                plt.close(fig)
                return None
            return fig
        except Exception as e:
            logger.warning("Could not plot level CDF: %s", e)

    def plot_state(self, filename: Optional[str] = None):
        """The history's ten-panel state plot."""
        import matplotlib.pyplot as plt

        h = self.history
        if not h or not h["logZ"]:
            return None
        fig = self._state_figure(h)
        if filename:
            fig.savefig(filename)
            plt.close(fig)
            return None
        return fig

    def plot_trace(self, enable_colours: bool = True, filename: Optional[str] = None, **kwargs):
        """Every stored sample against logW, one panel per parameter,
        coloured by the level that drew it."""
        import matplotlib.pyplot as plt

        if self.samples_unit is None:
            return None
        samples = self.samples_unit
        parameters = [p for p in samples.dtype.names if p != "logW"]
        n = len(parameters)
        fig, axs = plt.subplots(n, 1, sharex=True, figsize=(5, 2 * n), squeeze=False)
        colour_kwargs = dict(c=samples["it"], vmin=-1, vmax=samples["it"].max()) if enable_colours else {}
        for ax, p in zip(axs[:, 0], parameters):
            ax.scatter(samples["logW"], samples[p], s=1.0, **colour_kwargs)
            ax.set_ylabel(p)
        axs[-1, 0].set_xlabel("Log W")
        fig.tight_layout()
        if filename is not None:
            fig.savefig(filename)
            plt.close(fig)
            return None
        return fig

    def plot_extra_state(self, filename: Optional[str] = None):
        """logX, the gradient, the leakages and the entropies by level."""
        import matplotlib.pyplot as plt

        h = self.history
        if not h or not h.get("logX"):
            return None
        fig, axs = plt.subplots(4, 1, sharex=True, figsize=(10, 12))
        its = np.arange(len(h["logX"]))
        axs[0].plot(its, h["logX"])
        axs[0].set_ylabel("Log X")
        axs[1].plot(its, h["gradients"][: len(its)])
        axs[1].set_ylabel("dlogL/dlogX")
        axs[2].plot(its, h["leakage_live_points"][: len(its)], label="Total leakage")
        axs[2].plot(its, h["leakage_new_points"][: len(its)], label="New leakage")
        axs[2].set_ylabel("Leakage")
        axs[2].legend()
        axs[3].plot(its, h["samples_entropy"][: len(its)], label="Overall")
        axs[3].plot(its, h["proposal_entropy"][: len(its)], label="Current")
        axs[3].set_ylabel("Differential\n entropy")
        axs[3].legend()
        axs[-1].set_xlabel("Iteration")
        fig.tight_layout()
        if filename:
            fig.savefig(filename)
            plt.close(fig)
            return None
        return fig

    def produce_plots(self, override: bool = False) -> None:
        """The periodic plots (with ``plot``, or ``override``)."""
        if not (self.plot or override):
            return
        try:
            self.plot_state(os.path.join(self.output, "state.png"))
            if self._plot_trace and self.samples_unit is not None:
                self.plot_trace(filename=os.path.join(self.output, "trace.png"), **self.trace_plot_kwargs)
            if self._plot_likelihood_levels and self.samples_unit is not None:
                self.plot_likelihood_levels(os.path.join(self.output, "likelihood_levels.png"))
            if self._plot_extra_state:
                self.plot_extra_state(os.path.join(self.output, "state_extra.png"))
        except Exception as e:
            logger.warning("Could not produce INS plots: %s", e)

    def _state_figure(self, h):
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(5, 2, figsize=(12, 15), sharex=True)
        axs = axs.ravel()
        its = np.arange(len(h["logZ"]))
        for ci in h.get("checkpoint_iterations", []):
            for a in axs:
                a.axvline(ci, ls=":", color="#66ccff")
        axs[0].plot(its, h["logZ"])
        axs[0].set_ylabel("logZ")
        axs[1].plot(its, h["min_log_likelihood"], label="min logL")
        axs[1].plot(its, h["max_log_likelihood"], label="max logL")
        axs[1].plot(its, h["logL_threshold"], label="threshold")
        axs[1].set_ylabel("logL")
        axs[1].legend()
        axs[2].plot(its, h["live_points_ess"])
        axs[2].set_ylabel("live ESS")
        axs[3].plot(its, h["logX"])
        axs[3].set_ylabel("logX")
        axs[4].plot(its, h["gradients"])
        axs[4].set_ylabel("dlogL/dlogX")
        axs[5].plot(its, h["leakage_live_points"], label="live")
        axs[5].plot(its, h["leakage_new_points"][: len(its)], label="new")
        axs[5].set_ylabel("leakage")
        axs[5].legend()
        axs[6].plot(its, h["samples_entropy"], label="samples")
        axs[6].plot(its, h["proposal_entropy"], label="proposal")
        axs[6].set_ylabel("entropy")
        axs[6].legend()
        for k, v in h["stopping_criteria"].items():
            axs[7].plot(its, v, label=k)
        axs[7].set_ylabel("criteria")
        axs[7].legend()
        # each level's importance (the prior left out)
        if self.importance.get("total") is not None:
            imp_its = np.arange(len(self.importance["total"]) - 1)
            for key in ("total", "posterior", "evidence"):
                axs[8].plot(imp_its, self.importance[key][1:], label=key.capitalize())
            axs[8].set_ylabel("importance")
            axs[8].legend()
        if h.get("n_added"):
            axs[9].plot(np.arange(len(h["n_added"])), h["n_added"], label="added")
            axs[9].plot(np.arange(len(h["n_removed"])), h["n_removed"], label="removed")
            axs[9].set_ylabel("# samples")
            axs[9].legend()
        axs[8].set_xlabel("iteration")
        axs[9].set_xlabel("iteration")
        fig.tight_layout()
        return fig

    # ------------------------------------------------------------------
    # Result and resume
    # ------------------------------------------------------------------
    def get_result_dictionary(self) -> dict:
        """The run's result: the evidence of each sample set, the
        samples, the level weights' importance and the times."""
        d = super().get_result_dictionary()
        d.update(
            dict(
                log_evidence=self.log_evidence,
                log_evidence_error=self.log_evidence_error,
                nested_samples=np.asarray(self.samples_unit),
                sample_counts=self.sample_counts,
                iterations=self.iteration,
                stopping_criteria=self.criterion,
                effective_n_posterior_samples=self.state.effective_n_posterior_samples,
                training_time=self.training_time.total_seconds(),
                draw_samples_time=self.draw_samples_time.total_seconds(),
                add_and_update_samples_time=self.add_and_update_samples_time.total_seconds(),
                draw_final_samples_time=self.draw_final_samples_time.total_seconds(),
                n_levels=self.proposal.n_proposals,
            )
        )
        d["training_samples"] = self.model.from_unit_hypercube(self.training_samples.samples)
        d["training_log_evidence"] = self.training_samples.state.log_evidence
        d["training_log_evidence_error"] = self.training_samples.state.log_evidence_error
        d["training_log_posterior_weights"] = self.training_samples.state.log_posterior_weights
        d["bootstrap_log_evidence"] = self.bootstrap_log_evidence
        d["bootstrap_log_evidence_error"] = self.bootstrap_log_evidence_error
        if self.iid_samples:
            d["iid_log_evidence"] = self.iid_samples.state.log_evidence
            d["iid_log_evidence_error"] = self.iid_samples.state.log_evidence_error
        d["log_posterior_weights"] = (
            self.final_log_posterior_weights if self.final_state is not None else self.state.log_posterior_weights
        )
        d["proposal_importance"] = self.importance
        if self.final_samples_unit is not None:
            d["samples"] = self.final_samples
            d["final_samples"] = self.final_samples_unit
            d["final_log_evidence"] = self.final_log_evidence
            d["log_evidence"] = self.final_log_evidence
            d["log_evidence_error"] = self.final_log_evidence_error
        return d

    def __getstate__(self):
        # the sample stores drop their log_q matrices unless save_log_q
        state = super().__getstate__()
        for key in ("training_samples", "iid_samples"):
            if state.get(key) is not None:
                state[key].save_log_q = self.save_log_q
        return state

    @classmethod
    def resume_from_pickled_sampler(
        cls,
        sampler,
        model,
        flow_config=None,
        training_config=None,
        weights_path=None,
        rng=None,
        device=None,
        **kwargs,
    ):
        """Rebind ``model``, rebuild the levels on ``device`` from their
        weight files and, where the pickle holds no log_q matrices,
        recompute them through the levels."""
        cls.add_fields()
        sampler = super().resume_from_pickled_sampler(sampler, model, rng=rng, device=device, **kwargs)
        sampler.proposal.device = sampler.device
        sampler.proposal.resume(model, flow_config=flow_config, training_config=training_config,
                                weights_path=weights_path)
        for ordered in (sampler.training_samples, sampler.iid_samples):
            if ordered is not None and ordered.log_q is None:
                x_prime, log_j = sampler.proposal.rescale(ordered.samples)
                _, ordered.log_q = sampler.proposal.compute_log_Q(x_prime, log_j)
        return sampler
