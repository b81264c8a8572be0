"""Standard nested sampler with a flow proposal. Counterpart of
``nessai_tpu/samplers/nestedsampler.py``.

Three ways to consume a populated pool, each giving the same bits:

- device stepping (``device_bookkeeping``, the default): the proposal's
  device populate chains the consume/insert scan (``ns_device.py``, the
  kernel of ``ops/ns_scan.py``) onto the pool, and
  :meth:`NestedSampler._consume_from_pool_device` commits its trajectory
  with the float64 evidence replayed on the host;
- the host batched pass :meth:`NestedSampler._consume_from_pool_batched`
  (``batched_bookkeeping``, the default), where device stepping does not
  apply;
- the sequential :meth:`NestedSampler.consume_sample`, one iteration at
  a time, which the other two reproduce.

Device work (flow training, pool population, likelihoods, the scan)
happens inside the proposals.
"""

import contextlib
import datetime
import logging
import math
import os
import signal
import threading
from collections import deque
from typing import Optional

import numpy as np

from ..evidence import _NSIntegralState
from ..livepoint import empty_structured_array
from ..proposal import AnalyticProposal, RejectionProposal
from ..proposal.utils import check_proposal_kwargs, get_flow_proposal_class
from ..stopping_criteria import StoppingCriterionRegistry
from ..utils.indices import compute_indices_ks_test
from ..utils.profiling import annotate
from ..utils.stats import effective_sample_size
from .base import BaseNestedSampler

logger = logging.getLogger(__name__)

__all__ = ["NestedSampler"]

#: the signals that ``FlowSampler`` checkpoints and exits on
_CHECKPOINT_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)


@contextlib.contextmanager
def _signals_held():
    """Hold the checkpointing signals until the block ends: one that
    arrives inside it is recorded and raised again at its end, so that
    its handler runs before or after the block and never sees half of
    its state changes. Python runs signal handlers in the main thread
    only; elsewhere the block runs as it is."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    previous = {s: signal.getsignal(s) for s in _CHECKPOINT_SIGNALS}
    # a handler installed outside Python cannot be put back
    held = [s for s, handler in previous.items() if handler is not None]
    caught = []
    for s in held:
        signal.signal(s, lambda signum, frame: caught.append(signum))
    try:
        yield
    finally:
        for s in held:
            signal.signal(s, previous[s])
        for signum in dict.fromkeys(caught):
            signal.raise_signal(signum)


class NestedSampler(BaseNestedSampler):
    """Standard nested sampler.

    ``device`` (default CUDA) is where the flow trains and the pool is
    populated; the sampling loop itself runs on the host in float64.
    The run stops when the estimated remaining evidence ``dlogZ`` falls
    to the tolerance ``stopping`` (or at ``max_iteration``). The
    uninformed proposal (rejection sampling from the prior, or with
    ``analytic_priors`` exact prior draws) runs until its acceptance
    falls below ``uninformed_acceptance_threshold`` or
    ``maximum_uninformed`` iterations; then the flow proposal
    (``flow_class``, :class:`FlowProposal` by default, which takes the
    remaining keyword arguments) trains on the live points whenever its
    pool runs empty (``train_on_empty``), its acceptance falls below
    ``acceptance_threshold`` after ``cooldown`` iterations
    (``retrain_acceptance``) or every ``training_frequency`` iterations,
    and resets its weights and permutations on the schedule of
    ``reset_weights``, ``reset_permutations`` and ``reset_flow``.
    ``batched_bookkeeping`` consumes each pool in one pass rather than
    an iteration at a time, and ``device_bookkeeping`` steps through the
    pool on the device where the proposal populates there; neither
    changes the run's bits.
    """

    #: set while a device commit holds the periodic checkpoints
    _in_device_commit = False

    def __init__(
        self,
        model,
        nlive: int = 2000,
        output: Optional[str] = None,
        stopping: float = 0.1,
        stopping_criterion: str = "dlogZ",
        max_iteration: Optional[int] = None,
        checkpointing: bool = True,
        checkpoint_interval: int = 600,
        checkpoint_on_iteration: bool = False,
        checkpoint_on_training: bool = False,
        checkpoint_callback=None,
        logging_interval: Optional[int] = None,
        log_on_iteration: bool = True,
        resume_file: Optional[str] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        plot: bool = True,
        prior_sampling: bool = False,
        analytic_priors: bool = False,
        maximum_uninformed: Optional[float] = None,
        uninformed_proposal=None,
        uninformed_acceptance_threshold: Optional[float] = None,
        uninformed_proposal_kwargs: Optional[dict] = None,
        training_frequency=None,
        cooldown: int = 200,
        memory=False,
        acceptance_threshold: float = 0.01,
        retrain_acceptance: bool = True,
        train_on_empty: bool = True,
        reset_weights=False,
        reset_permutations=False,
        reset_acceptance: bool = False,
        reset_flow=False,
        flow_class=None,
        flow_proposal_class=None,
        trace_parameters: Optional[list] = None,
        flow_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        proposal_plots: bool = False,
        shrinkage_expectation: str = "logt",
        batched_bookkeeping: bool = True,
        device_bookkeeping: bool = True,
        simulated_evidence_error=True,
        n_pool: Optional[int] = None,
        pool=None,
        close_pool: bool = False,
        device=None,
        **kwargs,
    ):
        #: close the model's pool when the sampling loop ends
        self._close_pool = close_pool
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
        self.prior_sampling = prior_sampling
        self.batched_bookkeeping = batched_bookkeeping
        self.device_bookkeeping = device_bookkeeping
        #: draws of the simulated evidence error (True: 500, an int: that
        #: many, False or 0: none)
        self.simulated_evidence_error = simulated_evidence_error
        self.log_evidence_error_simulated = None
        #: parameters of the trace plot (by default every model parameter)
        self.trace_parameters = list(trace_parameters) if trace_parameters is not None else list(model.names)
        if flow_proposal_class is not None:
            if flow_class is not None:
                raise RuntimeError("Specify only one of flow_proposal_class / flow_class")
            flow_class = flow_proposal_class
        self.checkpoint_on_training = checkpoint_on_training
        self.configure_max_iteration(max_iteration)
        self.acceptance_threshold = acceptance_threshold
        self.retrain_acceptance = retrain_acceptance
        self.train_on_empty = train_on_empty
        self.cooldown = cooldown
        self.memory = memory
        self.configure_flow_reset(reset_weights, reset_permutations, reset_flow)
        self.reset_acceptance = reset_acceptance
        self.state = _NSIntegralState(self.nlive, expectation=shrinkage_expectation)
        self.stopping_criterion = StoppingCriterionRegistry.get(stopping_criterion, tolerance=stopping)
        self.condition = np.inf
        self.configure_training_frequency(training_frequency)

        self.live_points = None
        self.accepted = 0
        self.rejected = 1
        self.initialised = False
        self.nested_samples = []
        self.logLmin = -np.inf
        self.logLmax = -np.inf
        self.insertion_indices = []
        self.rolling_p = []
        self.final_p_value = None
        self.final_ks_statistic = None
        self.acceptance_history = deque(maxlen=(self.nlive // 10))
        self.block_acceptance = 1.0
        self.block_iteration = 0
        self.mean_block_acceptance = 1.0
        self.training_iterations = []
        self.train_count = 0
        self.last_updated = 0
        self.completed_training = True
        self.uninformed_sampling = True
        self.training_time = datetime.timedelta()
        self._count_carry = 0

        self.configure_uninformed_proposal(
            uninformed_proposal,
            analytic_priors,
            maximum_uninformed,
            uninformed_acceptance_threshold,
            **(uninformed_proposal_kwargs or {}),
        )
        self.configure_flow_proposal(flow_class, flow_config, training_config, proposal_plots, **kwargs)
        self.proposal = self._uninformed_proposal

    # ------------------------------------------------------------------
    # Configuration
    # ------------------------------------------------------------------
    def configure_max_iteration(self, max_iteration) -> None:
        """The iteration cap (None: no cap)."""
        self.max_iteration = np.inf if max_iteration is None else max_iteration

    def configure_training_frequency(self, training_frequency) -> None:
        """Retrain every ``training_frequency`` iterations; None, ``"inf"``
        and ``"None"`` mean only when the other conditions hold."""
        if training_frequency in (None, "inf", "None"):
            self.training_frequency = np.inf
        else:
            self.training_frequency = training_frequency

    def configure_flow_reset(self, reset_weights, reset_permutations, reset_flow) -> None:
        """Reset the flow's weights (permutations) every ``reset_weights``
        (``reset_permutations``) trainings, False for never; ``reset_flow``
        sets both."""
        for name, value in (
            ("reset_weights", reset_weights),
            ("reset_permutations", reset_permutations),
            ("reset_flow", reset_flow),
        ):
            if not isinstance(value, (int, float)):
                raise TypeError(f"`{name}` must be a bool, int or float")
            setattr(self, name, float(value))
        if self.reset_flow:
            self.reset_weights = self.reset_flow
            self.reset_permutations = self.reset_flow

    def configure_uninformed_proposal(
        self, uninformed_proposal, analytic_priors, maximum_uninformed, uninformed_acceptance_threshold, **kwargs
    ) -> None:
        """The proposal of the uninformed phase (``uninformed_proposal``,
        or :class:`AnalyticProposal` with ``analytic_priors``, else
        :class:`RejectionProposal`, built with ``kwargs``) and the rules
        of the switch: at most ``maximum_uninformed`` iterations (10 ×
        nlive by default, 0 for False), and an acceptance threshold (by
        default the larger of 0.5 and 10 × ``acceptance_threshold``)."""
        if maximum_uninformed is None:
            self.maximum_uninformed = 10 * self.nlive
        elif maximum_uninformed is False:
            self.maximum_uninformed = 0
        else:
            self.maximum_uninformed = float(maximum_uninformed)
        if uninformed_acceptance_threshold is None:
            self.uninformed_acceptance_threshold = max(0.5, 10 * self.acceptance_threshold)
        else:
            self.uninformed_acceptance_threshold = uninformed_acceptance_threshold
        kwargs.setdefault("poolsize", self.nlive)
        if uninformed_proposal is None:
            uninformed_proposal = AnalyticProposal if analytic_priors else RejectionProposal
        self._uninformed_proposal = uninformed_proposal(self.model, rng=self.rng, **kwargs)

    def configure_flow_proposal(self, flow_proposal_class, flow_config, training_config, proposal_plots, **kwargs):
        """The flow proposal of class ``flow_proposal_class`` (a name or a
        class, see :func:`get_flow_proposal_class`) with the keyword
        arguments it takes (:func:`check_proposal_kwargs`), on the
        sampler's device; the pool holds nlive points unless ``poolsize``
        says otherwise."""
        proposal_class = get_flow_proposal_class(flow_proposal_class)
        kwargs = check_proposal_kwargs(proposal_class, kwargs)
        kwargs.setdefault("poolsize", self.nlive)
        self._flow_proposal = proposal_class(
            self.model,
            flow_config=flow_config,
            training_config=training_config,
            output=os.path.join(self.output, "proposal", ""),
            plot=proposal_plots,
            rng=self.rng,
            device=self.device,
            **kwargs,
        )
        # the weight files are read only at resume: none without
        # checkpoints
        self._flow_proposal.save_flow_weights = bool(self.checkpointing)

    # ------------------------------------------------------------------
    @property
    def flow_proposal(self):
        return self._flow_proposal

    @property
    def acceptance(self) -> float:
        return self.iteration / max(self.likelihood_calls, 1)

    @property
    def tolerance(self) -> float:
        """The stopping criterion's tolerance on dlogZ."""
        return self.stopping_criterion.tolerance

    @property
    def mean_acceptance(self) -> float:
        """Mean acceptance of the last ``nlive // 10`` blocks."""
        if not self.acceptance_history:
            return np.nan
        return float(np.mean(self.acceptance_history))

    @property
    def last_iteration_with_flow(self):
        return self.iteration - self.last_updated

    @property
    def proposal_population_time(self):
        """The population time of both proposals together."""
        return self._uninformed_proposal.population_time + self._flow_proposal.population_time

    def check_resume(self) -> None:
        """After a resume, restore the proposal switch and a populated
        pool that the proposal marked for resuming."""
        if getattr(self, "resumed", False):
            if self.uninformed_sampling is False:
                self.check_proposal_switch(force=True)
            if getattr(self._flow_proposal, "resume_populated", False) and getattr(
                self._flow_proposal, "indices", None
            ):
                self._flow_proposal.populated = True
                logger.info("Resumed with populated pool")
            self.resumed = False

    def update_output(self, output: str) -> None:
        """Move the output directory, with the flow proposal's output and
        its weight files, into ``output``."""
        super().update_output(output)
        self._flow_proposal.output = os.path.join(output, "proposal", "")
        if self._flow_proposal.flow is not None:
            self._flow_proposal.flow.output = self._flow_proposal.output

    @property
    def log_evidence(self) -> float:
        return self.state.log_evidence

    @property
    def log_evidence_error(self) -> float:
        return self.state.log_evidence_error

    @property
    def information(self) -> float:
        return self.state.info[-1]

    @property
    def posterior_effective_sample_size(self) -> float:
        """Kish's effective sample size of the posterior weights."""
        return effective_sample_size(self.state.log_posterior_weights())

    @property
    def birth_log_likelihoods(self) -> np.ndarray:
        """The likelihood threshold at which each nested sample was born."""
        return np.array(self.state.logLs)[self.nested_samples_array["it"]].flatten()

    def simulate_evidence_uncertainty(self, n_simulations: int = 500, rng=None) -> np.ndarray:
        """Draws of logZ under simulated prior-volume shrinkages, from the
        sampler's ``rng`` unless one is given; their spread is the
        simulated error."""
        return self.state.simulate_log_evidence(n_simulations, rng=rng if rng is not None else self.rng)

    @property
    def nested_samples_array(self) -> np.ndarray:
        """``nested_samples`` as one structured array (rows of one dtype
        are joined as bytes, which is much faster than ``np.array`` over
        ``np.void`` rows)."""
        rows = self.nested_samples
        if rows and all(
            isinstance(r, np.void) and r.dtype == rows[0].dtype for r in rows
        ):
            return np.frombuffer(
                b"".join(r.tobytes() for r in rows), dtype=rows[0].dtype
            ).copy()
        return np.array(rows)

    # ------------------------------------------------------------------
    def initialise(self, live_points: bool = True) -> None:
        """Initialise the proposals and draw the live points."""
        if not self._flow_proposal.initialised:
            self._flow_proposal.initialise()
        if not self._uninformed_proposal.initialised:
            self._uninformed_proposal.initialise()
        # a resumed run past the switch keeps the flow proposal
        if self.uninformed_sampling and self.iteration < self.maximum_uninformed:
            self.proposal = self._uninformed_proposal
        else:
            self.proposal = self._flow_proposal
        if live_points and self.live_points is None:
            self.populate_live_points()
        self.initialise_history()
        self.initialised = True

    def populate_live_points(self) -> None:
        """Draw the initial live points from the prior, sorted by logL."""
        live_points = empty_structured_array(self.nlive, names=self.model.names)
        n = 0
        while n < self.nlive:
            point = self._uninformed_proposal.draw(None)
            if not np.isfinite(point["logL"]):
                continue
            live_points[n] = point
            n += 1
        live_points["it"] = -np.ones(self.nlive)
        self.live_points = np.sort(live_points, order="logL")
        self.logLmax = float(self.live_points["logL"][-1])

    def check_proposal_switch(self, force: bool = False) -> bool:
        """Switch from the uninformed to the flow proposal."""
        if not self.uninformed_sampling:
            return True
        if (
            force
            or self.mean_block_acceptance < self.uninformed_acceptance_threshold
            or self.iteration >= self.maximum_uninformed
        ):
            logger.info("Switching to flow proposal at iteration %s", self.iteration)
            self.proposal = self._flow_proposal
            self.proposal.ns_acceptance = self.mean_block_acceptance
            self.uninformed_sampling = False
            return True
        return False

    def check_training(self):
        """Whether to train now, and whether to force it past the
        cooldown: ``(train, force)``. Nothing while the pool lasts; on an
        empty pool, forced with ``train_on_empty``; forced where the
        acceptance fell below ``acceptance_threshold`` after ``cooldown``
        iterations of the block (``retrain_acceptance``); and every
        ``training_frequency`` iterations, outside the cooldown."""
        if not self.completed_training:
            return True, True
        if self.proposal.populated:
            return False, False
        train, force = False, False
        if self.train_on_empty:
            train, force = True, True
        if (
            self.retrain_acceptance
            and self.mean_block_acceptance < self.acceptance_threshold
            and self.block_iteration >= self.cooldown
        ):
            train, force = True, True
        if (self.iteration - self.last_updated) >= self.training_frequency:
            train = True
        if train and not force and (self.iteration - self.last_updated) < self.cooldown:
            train = False
        return train, force

    def check_flow_model_reset(self) -> None:
        """Before a training: reset the flow's weights and permutations
        where the acceptance fell below ``acceptance_threshold``
        (``reset_acceptance``), else the weights every ``reset_weights``
        and the permutations every ``reset_permutations`` trainings."""
        proposal = self._flow_proposal
        if not proposal.training_count:
            return
        if self.reset_acceptance and self.mean_block_acceptance < self.acceptance_threshold:
            proposal.flow.reset_model(weights=True, permutations=True)
            return
        weights = bool(self.reset_weights and not (proposal.training_count % self.reset_weights))
        permutations = bool(self.reset_permutations and not (proposal.training_count % self.reset_permutations))
        if weights or permutations:
            proposal.flow.reset_model(weights=weights, permutations=permutations)

    def train_proposal(self, force: bool = False) -> None:
        """Train the flow proposal on the current live points (with the
        last ``memory`` nested samples), not within the cooldown unless
        ``force``. Traced as the span ``training`` (its rows), whose id is
        the training's."""
        if not force and (self.iteration - self.last_updated) < self.cooldown:
            logger.debug("Not training; within cooldown")
            return
        with annotate("training") as span:
            span.set(training=span.id)
            self.check_flow_model_reset()
            logger.info("Training flow proposal at iteration %s", self.iteration)
            st = datetime.datetime.now()
            training_data = self.live_points.copy()
            if self.memory and len(self.nested_samples) >= self.memory:
                training_data = np.concatenate(
                    [training_data, np.asarray(self.nested_samples[-int(self.memory) :], dtype=training_data.dtype)]
                )
            span.set(rows=len(training_data))
            self._flow_proposal.train(training_data, plot=self.plot)
            self.training_time += datetime.datetime.now() - st
            self.training_iterations.append(self.iteration)
            self.last_updated = self.iteration
            self.block_iteration = 0
            self.block_acceptance = 0.0
            self.train_count += 1
            self.completed_training = True
        if self.checkpoint_on_training:
            self.checkpoint(periodic=True, force=True)

    # ------------------------------------------------------------------
    def yield_sample(self, oldparam):
        """Generator of ``(count, proposal)`` pairs."""
        while True:
            count = 0
            while True:
                count += 1
                new_sample = self.proposal.draw(oldparam.copy())
                if not np.isfinite(new_sample["logL"]):
                    new_sample["logL"] = self.model.evaluate_log_likelihood(new_sample)
                if new_sample["logL"] > self.logLmin:
                    break
                if not self.proposal.populated:
                    break
            yield count, new_sample

    def _pop_pool_vectorised(self):
        """One ``yield_sample`` round over a populated pool in one slice:
        pop everything up to and including the first entry above
        ``logLmin``. Returns ``(count, sample)``, or None to fall back to
        the generator."""
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if not getattr(proposal, "populated", False) or not indices or samples is None:
            return None
        order = indices[::-1]
        pool_logL = samples["logL"][order]
        if not np.all(np.isfinite(pool_logL)):
            return None
        hits = np.nonzero(pool_logL > self.logLmin)[0]
        if hits.size:
            m = int(hits[0])
            proposed = samples[order[m]]
            del indices[-(m + 1) :]
            if not indices:
                proposal.populated = False
            return m + 1, proposed
        count = len(order)
        proposed = samples[order[-1]]
        del indices[:]
        proposal.populated = False
        return count, proposed

    def insert_live_point(self, live_point) -> int:
        """Insert into the sorted live points (the worst already removed
        from slot 0); returns the insertion index."""
        index = np.searchsorted(self.live_points["logL"], live_point["logL"])
        self.live_points[: index - 1] = self.live_points[1:index]
        self.live_points[index - 1] = live_point
        return int(index) - 1

    def consume_sample(self) -> None:
        """Replace the worst live point."""
        worst = self.live_points[0].copy()
        self.logLmin = float(worst["logL"])
        self.state.increment(worst["logL"])
        self.nested_samples.append(worst)
        self.condition = (
            np.logaddexp(self.state.logZ, self.logLmax + self.state.logw) - self.state.logZ
        )
        count_total = self._count_carry
        self._count_carry = 0
        while True:
            fast = self._pop_pool_vectorised()
            if fast is not None:
                count, proposed = fast
            else:
                count, proposed = next(self._yield_iter)
            count_total += count
            if proposed["logL"] > self.logLmin:
                self.accepted += 1
                self.block_acceptance += 1.0 / count_total
                proposed["it"] = self.iteration
                self.insertion_indices.append(self.insert_live_point(proposed))
                self.logLmax = max(self.logLmax, float(self.live_points["logL"][-1]))
                break
            self.rejected += 1
            self.check_state()
            self._yield_iter = self.yield_sample(self.live_points[0])
        self.mean_block_acceptance = self.block_acceptance / max(self.block_iteration, 1)

    @staticmethod
    def _logaddexp(a: float, b: float) -> float:
        """Scalar replica of ``np.logaddexp`` (bit-identical on float64)."""
        if a == b:
            return a + 0.6931471805599453
        tmp = a - b
        if tmp > 0:
            return a + math.log1p(math.exp(-tmp))
        elif tmp <= 0:
            return b + math.log1p(math.exp(tmp))
        return a + b

    def _consume_from_pool_batched(self) -> bool:
        """Replay the sequential consume/insert/evidence loop over the
        populated pool in one host pass.

        While the pool is populated ``check_state`` does not train and,
        past the uninformed phase, ``check_proposal_switch`` does nothing,
        so the trajectory is fixed by the pool's contents. This reproduces
        :meth:`consume_sample` exactly: the same evidence increments,
        insertion indices, acceptance bookkeeping and history cadence.
        Acceptance is on strict ``logL > worst`` and insertion at
        ``searchsorted(side="left")``. Trailing entries that can no longer
        beat the worst point are left to the sequential path, so training
        and repopulation happen as they do there. Returns True if at least
        one iteration was consumed. Traced as the span ``commit`` (the
        pool's id, the iterations committed), with ``evidence_replay``
        under it and ``history`` at each boundary inside that.
        """
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if not self.completed_training or not getattr(proposal, "populated", False) or not indices or samples is None:
            return False
        with annotate("commit", pool=proposal.pool_id) as span:
            n_done = self._replay_pool(proposal, indices, samples)
            span.set(iterations=n_done)
        return n_done > 0

    def _replay_pool(self, proposal, indices, samples) -> int:
        """The host pass of :meth:`_consume_from_pool_batched`; returns
        the iterations it committed."""
        state = self.state
        order = np.asarray(indices[::-1], dtype=np.int64)
        pool_logL = np.ascontiguousarray(samples["logL"][order], dtype=np.float64)
        if not np.all(np.isfinite(pool_logL)):
            return 0
        pool_l = pool_logL.tolist()

        n = self.nlive
        R = np.concatenate([self.live_points, samples[order]])
        llogL = np.ascontiguousarray(R["logL"][:n], dtype=np.float64)
        ids = np.arange(n, dtype=np.int64)
        R_it = R["it"]

        logt = state.log_shrinkage(n)
        log1mexp_logt = math.log(-math.expm1(logt))
        logZ = float(state.logZ)
        oldZ = float(state.oldZ)
        logw = float(state.logw)
        info_last = float(state.info[-1])
        lastL = float(state.logLs[-1])
        logLmax = float(self.logLmax)
        it = self.iteration
        accepted = self.accepted
        block_acc = self.block_acceptance
        block_it = self.block_iteration
        cond = float(self.condition)
        tol = self.tolerance
        max_it = self.max_iteration
        uninformed = self.uninformed_sampling
        switch_thr = self.uninformed_acceptance_threshold
        max_uninformed = self.maximum_uninformed
        mean_acc = self.mean_block_acceptance
        hist_interval = max(n // 10, 1)
        K = pool_logL.shape[0]
        j = 0
        last_w = float(self.logLmin)
        inf_ = math.inf
        log1p = math.log1p
        exp = math.exp
        isfinite = math.isfinite
        isnan = math.isnan
        searchsorted = np.searchsorted
        ins_append = self.insertion_indices.append
        ns_append = self.nested_samples.append
        buf_logLs = []
        buf_vols = []
        buf_info = []
        buf_nlives = []
        n_done = 0
        carry = self._count_carry
        self._count_carry = 0

        def _sync():
            self.iteration = it
            self.condition = cond
            self.logLmin = last_w
            self.logLmax = logLmax
            self.accepted = accepted
            self.block_acceptance = block_acc
            self.block_iteration = block_it
            self.mean_block_acceptance = mean_acc
            state.logZ = logZ
            state.oldZ = oldZ
            state.logw = logw
            state.logLs.extend(buf_logLs)
            state.log_vols.extend(buf_vols)
            state.info.extend(buf_info)
            state.nlives.extend(buf_nlives)
            buf_logLs.clear()
            buf_vols.clear()
            buf_info.clear()
            buf_nlives.clear()

        with annotate("evidence_replay"):
            while cond > tol and j < K:
                if max_it and it >= max_it:
                    break
                if uninformed and (mean_acc < switch_thr or it >= max_uninformed):
                    break
                w = float(llogL[0])
                cnt = 1
                while j < K and pool_l[j] <= w:
                    j += 1
                    cnt += 1
                if j >= K:
                    # the remaining pops would exhaust the pool mid-iteration:
                    # rewind and let consume_sample drain them
                    j = K - (cnt - 1)
                    self._count_carry = carry
                    break
                last_w = w
                if w <= lastL:
                    state.nonmonotonic_count += 1
                    if state.nonmonotonic_count <= 5:
                        logger.warning(
                            "NS integrator received non-monotonic logL: %.5f -> %.5f",
                            lastL,
                            w,
                        )
                    elif state.nonmonotonic_count % 1000 == 0:
                        logger.warning(
                            "NS integrator received %d non-monotonic logL values so "
                            "far (ties are expected with float32 device likelihoods)",
                            state.nonmonotonic_count,
                        )
                Wt = logw + w + log1mexp_logt
                if Wt > logZ:
                    logZ = Wt + log1p(exp(logZ - Wt))
                elif Wt == -inf_:
                    pass
                else:
                    logZ = logZ + log1p(exp(Wt - logZ))
                if isfinite(oldZ):
                    info_v = exp(Wt - logZ) * w + exp(oldZ - logZ) * (info_last + oldZ) - logZ
                    if isnan(info_v):
                        info_v = 0.0
                else:
                    info_v = 0.0
                buf_info.append(info_v)
                info_last = info_v
                oldZ = logZ
                logw += logt
                buf_logLs.append(w)
                buf_vols.append(logw)
                buf_nlives.append(n)
                lastL = w
                ns_append(R[ids[0]])
                cond = self._logaddexp(logZ, logLmax + logw) - logZ
                p = pool_l[j]
                pid = n + j
                j += 1
                accepted += 1
                block_acc += 1.0 / (cnt + carry)
                carry = 0
                R_it[pid] = it
                idx = int(searchsorted(llogL, p))
                llogL[0 : idx - 1] = llogL[1:idx]
                llogL[idx - 1] = p
                ids[0 : idx - 1] = ids[1:idx]
                ids[idx - 1] = pid
                ins_append(idx - 1)
                last = float(llogL[n - 1])
                if last > logLmax:
                    logLmax = last
                it += 1
                block_it += 1
                n_done += 1
                # consume_sample computes this before the loop increments
                # block_iteration
                mean_acc = block_acc / max(block_it - 1, 1)
                if it % hist_interval == 0 or it % n == 0:
                    with annotate("history"):
                        _sync()
                        self.live_points = R[ids]
                        self.update_state()
                        self.periodically_log_state()

        if not n_done:
            return 0
        _sync()
        self.live_points = R[ids]
        del indices[-j:]
        if not indices:
            proposal.populated = False
        self._yield_iter = self.yield_sample(self.live_points[0])
        if not self.uninformed_sampling:
            self._flow_proposal.ns_acceptance = self.mean_block_acceptance
        else:
            self._uninformed_proposal.ns_acceptance = self.mean_block_acceptance
        self.checkpoint(periodic=True)
        return n_done

    # ------------------------------------------------------------------
    # Stepping on the device
    # ------------------------------------------------------------------
    def _device_step_eligible(self):
        """``(order, pool_logL, live32, pool32)`` for the device commit, or
        None where the host paths must run (``nestedsampler.py:1081-1131``
        of the JAX package): device bookkeeping on, plots off (the state
        plot needs the live set inside the pool), a populated pool, the
        plain integral state, and every logL finite and exactly
        representable in float32, so that the scan's float32 comparisons
        order the points as the host's float64 ones do."""
        if not getattr(self, "device_bookkeeping", False):
            return None
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if self.plot or not getattr(proposal, "populated", False) or not indices or samples is None:
            return None
        if type(self.state) is not _NSIntegralState:
            return None
        order = np.asarray(indices[::-1], dtype=np.int64)
        pool_logL = np.ascontiguousarray(samples["logL"][order], dtype=np.float64)
        live_logL = np.ascontiguousarray(self.live_points["logL"], dtype=np.float64)
        if not (np.all(np.isfinite(pool_logL)) and np.all(np.isfinite(live_logL))):
            return None
        pool32 = pool_logL.astype(np.float32)
        live32 = live_logL.astype(np.float32)
        if not (
            np.array_equal(pool32.astype(np.float64), pool_logL)
            and np.array_equal(live32.astype(np.float64), live_logL)
            and np.all(np.isfinite(pool32))
            and np.all(np.isfinite(live32))
        ):
            return None
        return order, pool_logL, live32, pool32

    def _drain_rejected_tail(self) -> None:
        """Drain a pool whose remaining entries cannot beat the worst live
        point, as ``yield_sample`` would, so that the next pool is
        populated by :meth:`_maybe_populate_for_device` with the scan
        chained on (``nestedsampler.py:1133-1172``): the pops count
        towards the next accepted iteration (``_count_carry``), the empty
        pool adds one to ``rejected`` and runs :meth:`check_state`, as
        the reject branch of :meth:`consume_sample` does."""
        if not getattr(self, "device_bookkeeping", False):
            return
        proposal = self.proposal
        if not getattr(proposal, "populated", False) or type(self.state) is not _NSIntegralState:
            return
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if not indices or samples is None or self.live_points is None:
            return
        logLs = samples["logL"][indices]
        next_worst = float(self.live_points["logL"][0])
        if not np.all(np.isfinite(logLs)) or np.any(logLs > next_worst):
            return
        self._count_carry = getattr(self, "_count_carry", 0) + len(indices)
        del indices[:]
        proposal.populated = False
        self.rejected += 1
        self.check_state()
        self._yield_iter = self.yield_sample(self.live_points[0])

    def _maybe_populate_for_device(self) -> None:
        """Populate an empty pool through the proposal's device populate
        with the consume/insert scan chained on
        (``nestedsampler.py:1174-1244``): the same trigger as the
        proposal's own ``draw`` (the poolsize update, the worst point,
        populating until populated) in the flow phase, and the prior
        populate in the uninformed phase, so the host stream and the pool
        are those of the host path; it only asks for the scan as well."""
        if not getattr(self, "device_bookkeeping", False):
            return
        proposal = self.proposal
        if (
            self.plot
            or getattr(proposal, "populated", False)
            or type(self.state) is not _NSIntegralState
            or self.live_points is None
        ):
            return
        uninformed = self.uninformed_sampling
        if uninformed:
            if not getattr(proposal, "_device_populate_ok", False):
                return
        elif not (
            self.completed_training
            and getattr(proposal, "_can_device_loop", False)
            and getattr(proposal, "populate_mode", None) != "rounds"
            and self.model.has_torch_likelihood
        ):
            return
        live_logL = np.ascontiguousarray(self.live_points["logL"], dtype=np.float64)
        if not np.all(np.isfinite(live_logL)):
            return
        live32 = live_logL.astype(np.float32)
        if not np.array_equal(live32.astype(np.float64), live_logL):
            return
        if self.max_iteration and np.isfinite(self.max_iteration):
            max_acc = int(self.max_iteration) - self.iteration
            if max_acc <= 0:
                return
        else:
            max_acc = 2**31 - 1
        proposal._ns_scan_request = (live32, max_acc)
        try:
            if uninformed:
                proposal.populate()
            else:
                if proposal.update_poolsize:
                    proposal.update_poolsize_scale(proposal.ns_acceptance)
                while not proposal.populated:
                    proposal.populate(self.live_points[0].copy(), n_samples=proposal.poolsize)
        finally:
            proposal._ns_scan_request = None

    def _consume_from_pool_device(self) -> bool:
        """Commit the consume/insert trajectory that the scan chained onto
        the pool just populated (``nestedsampler.py:1246-1516``).

        The scan gave the ordering: skips and accepts, insertion indices,
        the consumed points and the final live set. The float64 evidence
        is replayed here over that trajectory with the kernels of the
        sequential integrator (``np.add.accumulate`` and
        ``np.logaddexp.accumulate`` are strict left folds, and the
        information is a scalar loop in the increment's order), so the
        state committed is bit for bit that of :meth:`consume_sample` and
        of the batched pass. Where ``dlogZ <= tolerance``, the uninformed
        phase's switch or ``max_iteration`` lands inside the pool, the
        scan runs again on its own (:func:`~.ns_device.run_ns_scan`)
        with the exact accept cap, for the live set at that point.

        Returns True if at least one iteration was consumed. Traced as the
        span ``commit`` (the pool's id, the iterations committed), with
        ``evidence_replay`` and ``history`` under it."""
        proposal = self.proposal
        pending = getattr(proposal, "_pending_ns_scan", None)
        if pending is None:
            return False
        proposal._pending_ns_scan = None
        with annotate("commit", pool=proposal.pool_id) as span:
            n_commit = self._commit_scanned_pool(proposal, pending)
            span.set(iterations=n_commit)
        return n_commit > 0

    def _commit_scanned_pool(self, proposal, pending) -> int:
        """The commit of :meth:`_consume_from_pool_device`; returns the
        iterations it committed."""
        elig = self._device_step_eligible()
        if elig is None:
            return 0
        order, pool_logL, live32, pool32 = elig
        samples = proposal.samples
        indices = proposal.indices
        state = self.state
        n = self.nlive
        it0 = self.iteration
        if self.max_iteration and np.isfinite(self.max_iteration):
            max_acc = int(self.max_iteration) - it0
            if max_acc <= 0:
                return 0
        else:
            max_acc = 2**31 - 1
        # the chained scan must have seen this live set, pool and cap
        if (
            pending["mask"].shape[0] != order.size
            or pending["max_acc"] != min(max_acc, 2**31 - 1)
            or not np.array_equal(pending["live32"], live32)
        ):
            return 0
        mask = pending["mask"]
        consumed_all = pending["consumed"]
        ins_all = pending["ins"]
        final_ids = pending["final_ids"]
        n_acc = pending["n_acc"]
        if n_acc == 0:
            return 0

        with annotate("evidence_replay"):
            pos = np.nonzero(mask)[0][:n_acc]
            R = np.concatenate([self.live_points, samples[order]])
            w = np.ascontiguousarray(R["logL"][consumed_all[pos]], dtype=np.float64)
            p_acc = pool_logL[pos]
            ins = ins_all[pos]

            # the float64 evidence, in the sequential integrator's op order
            logt = state.log_shrinkage(n)
            c_shrink = math.log(-math.expm1(logt))
            lw = np.add.accumulate(np.concatenate(([state.logw], np.full(n_acc, logt))))
            logw_pre, logw_post = lw[:-1], lw[1:]
            Wt = (logw_pre + w) + c_shrink
            logZ_tr = np.logaddexp.accumulate(np.concatenate(([state.logZ], Wt)))[1:]
            oldZ_tr = np.concatenate(([state.oldZ], logZ_tr[:-1]))
            # logLmax as the dlogZ condition reads it: moved only by a
            # candidate in the top slot, and read before this insertion
            cand = np.where(ins == n - 1, p_acc, -np.inf)
            run_max = np.maximum.accumulate(cand)
            logLmax0 = float(self.logLmax)
            logLmax_pre = np.maximum(logLmax0, np.concatenate(([-np.inf], run_max[:-1])))
            logLmax_post = np.maximum(logLmax0, run_max)
            cond_tr = np.logaddexp(logZ_tr, logLmax_pre + logw_post) - logZ_tr

            # acceptance: the pops of each replacement from the accept
            # positions; the first also owns the pops drained from the last
            # pool's rejected tail
            cnt = np.diff(np.concatenate(([-1], pos))).astype(np.float64)
            cnt[0] += getattr(self, "_count_carry", 0)
            self._count_carry = 0
            ba_tr = np.add.accumulate(np.concatenate(([self.block_acceptance], 1.0 / cnt)))[1:]
            block_it_tr = self.block_iteration + 1 + np.arange(n_acc)
            mean_acc_tr = ba_tr / np.maximum(block_it_tr - 1, 1)

            # the stopping decision, checked after each replacement
            below = np.nonzero(cond_tr <= self.tolerance)[0]
            n_commit = int(below[0]) + 1 if below.size else int(n_acc)
            if self.uninformed_sampling:
                # check_proposal_switch at the top of each iteration: before
                # step k it sees the mean after step k - 1 and it0 + k
                mean_top = np.concatenate(([self.mean_block_acceptance], mean_acc_tr[:-1]))
                it_top = it0 + np.arange(n_acc)
                max_uninf = np.inf if self.maximum_uninformed is None else self.maximum_uninformed
                fire = (mean_top < self.uninformed_acceptance_threshold) | (it_top >= max_uninf)
                fire[0] = False
                hit = np.nonzero(fire)[0]
                if hit.size:
                    n_commit = min(n_commit, int(hit[0]))
            if n_commit < n_acc:
                from .ns_device import run_ns_scan

                with annotate("scan"):
                    _, _, _, final_ids, n_chk = run_ns_scan(live32, pool32, n_commit, device=self.device)
                if n_chk != n_commit:
                    return 0
                pos = pos[:n_commit]
                w = w[:n_commit]
                ins = ins[:n_commit]
                logw_pre = logw_pre[:n_commit]
                logw_post = logw_post[:n_commit]
                Wt = Wt[:n_commit]
                logZ_tr = logZ_tr[:n_commit]
                oldZ_tr = oldZ_tr[:n_commit]
                logLmax_post = logLmax_post[:n_commit]
                cond_tr = cond_tr[:n_commit]
                ba_tr = ba_tr[:n_commit]
                block_it_tr = block_it_tr[:n_commit]
                mean_acc_tr = mean_acc_tr[:n_commit]
            j_commit = int(pos[-1]) + 1
            consumed_ids = consumed_all[pos]

            # the information: a scalar loop in the increment's order
            info_vals = [0.0] * n_commit
            info_last = float(state.info[-1])
            wl = w.tolist()
            wtl = Wt.tolist()
            zl = logZ_tr.tolist()
            ozl = oldZ_tr.tolist()
            for i in range(n_commit):
                oz = ozl[i]
                if math.isfinite(oz):
                    z = zl[i]
                    v = math.exp(wtl[i] - z) * wl[i] + math.exp(oz - z) * (info_last + oz) - z
                    if math.isnan(v):
                        v = 0.0
                else:
                    v = 0.0
                info_last = v
                info_vals[i] = v

        # the commit sets the pool's final live set before it brings the
        # state up to each boundary: a checkpoint inside it, periodic or
        # taken by a signal handler, would pickle that live set beside an
        # earlier iteration, so both wait for its end
        with annotate("history"), self._checkpoints_held():
            # the non-monotonic screen, rate-limited as the integrator's
            lastL_tr = np.concatenate(([state.logLs[-1]], w[:-1]))
            nm = np.nonzero(w <= lastL_tr)[0]
            for i in nm[: max(0, 5 - state.nonmonotonic_count)]:
                logger.warning("NS integrator received non-monotonic logL: %.5f -> %.5f", lastL_tr[i], w[i])
            state.nonmonotonic_count += int(nm.size)

            # commit: stamp and rebuild the rows, then bring the state up to
            # each boundary in turn, so that the history and the rolling KS
            # test run there as in consume_sample
            R["it"][n + pos] = it0 + np.arange(n_commit)
            new_nested = R[consumed_ids]
            accepted0 = self.accepted
            hist_interval = max(n // 10, 1)
            self.live_points = R[final_ids]
            ins_list = ins.tolist()
            vols_list = logw_post.tolist()
            done = 0

            def sync_to(i):
                nonlocal done
                hi = i + 1
                self.iteration = it0 + hi
                self.condition = float(cond_tr[i])
                self.logLmin = wl[i]
                self.logLmax = float(logLmax_post[i])
                self.accepted = accepted0 + hi
                self.block_acceptance = float(ba_tr[i])
                self.block_iteration = int(block_it_tr[i])
                self.mean_block_acceptance = float(mean_acc_tr[i])
                state.logZ = float(logZ_tr[i])
                state.oldZ = float(logZ_tr[i])
                state.logw = float(logw_post[i])
                state.logLs.extend(wl[done:hi])
                state.log_vols.extend(vols_list[done:hi])
                state.info.extend(info_vals[done:hi])
                state.nlives.extend([n] * (hi - done))
                self.insertion_indices.extend(ins_list[done:hi])
                self.nested_samples.extend(new_nested[done:hi])
                done = hi

            for v in range(it0 + 1, it0 + n_commit + 1):
                if v % hist_interval == 0 or v % n == 0:
                    sync_to(v - it0 - 1)
                    self.update_state()
                    self.periodically_log_state()
            sync_to(n_commit - 1)

            del indices[-j_commit:]
            if not indices:
                proposal.populated = False
            self._yield_iter = self.yield_sample(self.live_points[0])
            if not self.uninformed_sampling:
                self._flow_proposal.ns_acceptance = self.mean_block_acceptance
            else:
                self._uninformed_proposal.ns_acceptance = self.mean_block_acceptance
        self._n_device_steps = getattr(self, "_n_device_steps", 0) + n_commit
        self.checkpoint(periodic=True)
        return n_commit

    @contextlib.contextmanager
    def _checkpoints_held(self):
        """Hold the periodic checkpoints and the checkpointing signals
        until the block ends."""
        self._in_device_commit = True
        try:
            with _signals_held():
                yield
        finally:
            self._in_device_commit = False

    def checkpoint(self, periodic: bool = False, force: bool = False, save_existing: Optional[bool] = None) -> None:
        """As the base class's; a periodic checkpoint waits for the end of
        a device commit, which writes it once the state is whole."""
        if periodic and not force and self._in_device_commit:
            return
        super().checkpoint(periodic=periodic, force=force, save_existing=save_existing)

    # ------------------------------------------------------------------
    def check_state(self, force: bool = False) -> None:
        """Before each replacement: at the switch from the uninformed
        proposal, train; after it, train as :meth:`check_training`
        decides."""
        if self.uninformed_sampling:
            if not self.check_proposal_switch():
                return
            force = True
        if force:
            self.train_proposal(force=True)
            return
        train, force_train = self.check_training()
        if train or force_train:
            self.train_proposal(force=force_train)

    def check_insertion_indices(self, rolling: bool = True) -> None:
        """KS test of the insertion indices."""
        if not self.insertion_indices:
            return
        indices = self.insertion_indices[-self.nlive :] if rolling else self.insertion_indices
        D, p = compute_indices_ks_test(indices, self.nlive)
        if p is None:
            return
        if rolling:
            self.rolling_p.append(p)
        else:
            self.final_p_value = p
            self.final_ks_statistic = D
            if p < 0.05:
                logger.warning("Final insertion-index p-value below 0.05: %.4f", p)

    def initialise_history(self) -> None:
        super().initialise_history()
        self.history.update(
            dict(
                logZ=[],
                dlogZ=[],
                logLmin=[],
                logLmax=[],
                acceptance=[],
                mean_acceptance=[],
                rolling_p=[],
                population_acceptance=[],
                training_iterations=[],
            )
        )

    def update_history(self) -> None:
        super().update_history()
        self.history["logZ"].append(self.state.logZ)
        self.history["dlogZ"].append(self.condition)
        self.history["logLmin"].append(self.logLmin)
        self.history["logLmax"].append(self.logLmax)
        self.history["acceptance"].append(self.acceptance)
        self.acceptance_history.append(self.mean_block_acceptance)
        self.history["mean_acceptance"].append(self.mean_block_acceptance)
        self.history["population_acceptance"].append(self.proposal.population_acceptance)

    def update_state(self) -> None:
        """Periodic diagnostics."""
        if not self.uninformed_sampling:
            self._flow_proposal.ns_acceptance = self.mean_block_acceptance
        else:
            self._uninformed_proposal.ns_acceptance = self.mean_block_acceptance
        if not (self.iteration % max(self.nlive // 10, 1)):
            self.update_history()
        if not (self.iteration % self.nlive):
            self.check_insertion_indices(rolling=True)
            if self.plot:
                self.plot_state(filename=os.path.join(self.output, "state.png"))
        self.checkpoint(periodic=True)

    def log_state(self) -> None:
        logger.info(
            "it: %5d: n eval: %d H: %.2f dlogZ: %.3f logZ: %.3f +/- %.3f logLmax: %.2f",
            self.iteration,
            self.total_likelihood_evaluations,
            self.information,
            self.condition,
            self.state.logZ,
            self.state.log_evidence_error,
            self.logLmax,
        )

    def finalise(self) -> None:
        """Consume the remaining live points and re-integrate."""
        if self.finalised:
            return
        for i, point in enumerate(self.live_points):
            self.state.increment(point["logL"], nlive=self.nlive - i)
            self.nested_samples.append(point.copy())
        self.state.finalise()
        self.condition = 0.0
        self.finalised = True

    def compute_simulated_evidence_error(self) -> None:
        """The spread of ``simulated_evidence_error`` draws of logZ under
        simulated prior-volume shrinkages (none where it is False or 0)."""
        if not self.simulated_evidence_error:
            return
        n_sims = 500 if isinstance(self.simulated_evidence_error, bool) else int(self.simulated_evidence_error)
        self.log_evidence_error_simulated = float(np.std(self.simulate_evidence_uncertainty(n_sims)))

    def nested_sampling_loop(self):
        """The main loop. Returns ``(logZ, nested_samples)``. What follows
        the loop is traced as the span ``finalise``."""
        self.sampling_start_time = datetime.datetime.now()
        if not self.initialised:
            self.initialise()
        if self.prior_sampling:
            for point in self.live_points:
                self.nested_samples.append(point.copy())
            logger.info("Prior sampling only; skipping NS loop")
            if self._close_pool:
                self.close_pool()
            return self.state.logZ, self.nested_samples_array
        self._yield_iter = self.yield_sample(self.live_points[0])
        while self.condition > self.tolerance:
            self.check_state()
            if self.batched_bookkeeping:
                self._drain_rejected_tail()
                self._maybe_populate_for_device()
            if not (
                self.batched_bookkeeping
                and (self._consume_from_pool_device() or self._consume_from_pool_batched())
            ):
                self.consume_sample()
                self.iteration += 1
                self.block_iteration += 1
                self.update_state()
                self.periodically_log_state()
            if self.max_iteration and self.iteration >= self.max_iteration:
                logger.warning("Reached max iteration (%s)", self.max_iteration)
                break
        with annotate("finalise"):
            self.finalise()
            self.check_insertion_indices(rolling=False)
            self.compute_simulated_evidence_error()
            logger.info(
                "Final logZ: %.4f +/- %.4f (%d iterations, %d likelihood evaluations)",
                self.state.logZ,
                self.state.log_evidence_error,
                self.iteration,
                self.total_likelihood_evaluations,
            )
            self.sampling_time += datetime.datetime.now() - self.sampling_start_time
            self.sampling_start_time = datetime.datetime.now()
            if self.checkpointing:
                self.checkpoint(force=True)
            if self._close_pool:
                self.close_pool()
            return self.state.logZ, self.nested_samples_array

    # ------------------------------------------------------------------
    # Plots: each logs its failure (no matplotlib, say) and carries on
    # ------------------------------------------------------------------
    def plot_state(self, filename: Optional[str] = None):
        """The history's multi-panel state plot."""
        try:
            from ..plot import plot_sampler_state

            return plot_sampler_state(self, filename=filename)
        except Exception as e:
            logger.warning("Could not produce state plot: %s", e)

    def plot_trace(self, filename: Optional[str] = None):
        """The nested samples' trace against log prior volume."""
        try:
            from ..plot import plot_trace

            return plot_trace(
                self.state.log_vols[1:],
                self.nested_samples_array,
                parameters=self.trace_parameters,
                filename=filename,
            )
        except Exception as e:
            logger.warning("Could not produce trace plot: %s", e)

    def plot_insertion_indices(self, filename: Optional[str] = None):
        """The insertion indices' histogram and cumulative distribution."""
        try:
            from ..plot import plot_indices

            return plot_indices(self.insertion_indices, self.nlive, filename=filename)
        except Exception as e:
            logger.warning("Could not produce indices plot: %s", e)

    # ------------------------------------------------------------------
    def get_result_dictionary(self) -> dict:
        """The run's result: evidence, samples, diagnostics and times."""
        d = super().get_result_dictionary()
        d.update(
            dict(
                log_evidence=self.state.logZ,
                log_evidence_error=self.state.log_evidence_error,
                log_evidence_error_simulated=self.log_evidence_error_simulated,
                information=self.information,
                nested_samples=self.nested_samples_array,
                log_posterior_weights=self.state.log_posterior_weights(),
                insertion_indices=self.insertion_indices,
                rolling_p=self.rolling_p,
                final_p_value=self.final_p_value,
                final_ks_statistic=self.final_ks_statistic,
                training_time=self.training_time.total_seconds(),
                population_time=self._flow_proposal.population_time.total_seconds(),
                likelihood_evaluations=self.total_likelihood_evaluations,
                iteration=self.iteration,
                seed=self.seed,
            )
        )
        return d

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_yield_iter", None)
        state.pop("_in_device_commit", None)
        return state

    def __setstate__(self, state):
        # a pickle without the flag steps on the device, as the JAX
        # package's older pickles do
        state.setdefault("device_bookkeeping", True)
        self.__dict__.update(state)

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
        """Rebind ``model`` and rebuild the flow proposal's flow on
        ``device`` from its last weight file (``weights_path`` overrides
        it). Its pool is not in the pickle, so the resumed run
        populates afresh."""
        sampler = super().resume_from_pickled_sampler(sampler, model, rng=rng, device=device, **kwargs)
        sampler._uninformed_proposal.resume(model)
        sampler._flow_proposal.device = sampler.device
        sampler._flow_proposal.resume(
            model,
            flow_config=flow_config,
            training_config=training_config,
            weights_file=weights_path,
        )
        if sampler.uninformed_sampling:
            sampler.proposal = sampler._uninformed_proposal
        else:
            sampler.proposal = sampler._flow_proposal
        return sampler
