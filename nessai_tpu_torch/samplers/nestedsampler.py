"""Standard nested sampler with a flow proposal. Counterpart of
``nessai_tpu/samplers/nestedsampler.py``.

The loop consumes each populated pool with the host batched pass
:meth:`NestedSampler._consume_from_pool_batched`, the bit-exact twin of
the sequential :meth:`NestedSampler.consume_sample` (the JAX package's
device stepping, ``samplers/ns_device.py``, is its float32 replica and is
not ported). Device work (flow training, pool population, likelihoods)
happens inside the proposals.
"""

import datetime
import logging
import math
import os
from collections import deque
from typing import Optional

import numpy as np

from ..evidence import _NSIntegralState
from ..livepoint import empty_structured_array
from ..proposal import FlowProposal, RejectionProposal
from ..utils.indices import compute_indices_ks_test
from .base import BaseNestedSampler

logger = logging.getLogger(__name__)

__all__ = ["NestedSampler", "check_reference_options", "PROPOSAL_OPTIONS"]

#: The JAX sampler's keyword options that the port does not take yet:
#: for each, the one value the port runs with (the reference's default,
#: or the port's fixed choice) and the ROADMAP §1 item that brings the
#: others.
FIXED_OPTIONS = {
    "stopping": (0.1, "6"),
    "stopping_criterion": ("dlogZ", "6"),
    "max_iteration": (None, "6"),
    "prior_sampling": (False, "6"),
    "analytic_priors": (False, "6"),
    "maximum_uninformed": (None, "6"),
    "uninformed_proposal": (None, "6"),
    "uninformed_acceptance_threshold": (None, "6"),
    "uninformed_proposal_kwargs": (None, "6"),
    "training_frequency": (None, "6"),
    "cooldown": (200, "6"),
    "memory": (False, "6"),
    "acceptance_threshold": (0.01, "6"),
    "retrain_acceptance": (True, "6"),
    "train_on_empty": (True, "6"),
    "reset_weights": (False, "6"),
    "reset_permutations": (False, "6"),
    "reset_acceptance": (False, "6"),
    "reset_flow": (False, "6"),
    "flow_class": (None, "6"),
    "flow_proposal_class": (None, "6"),
    "shrinkage_expectation": ("logt", "6"),
    "batched_bookkeeping": (True, "6"),
    "device_bookkeeping": (True, "6"),
    "simulated_evidence_error": (True, "6"),
}


def _is_fixed(value, fixed) -> bool:
    # a bool or None matches only itself (True == 1 in Python), a number
    # or a string an equal plain number or string
    if fixed is None or isinstance(fixed, bool):
        return value is fixed
    return type(value) in (int, float, str) and value == fixed


#: The flow proposal's options that the port takes, passed on to
#: :class:`~nessai_tpu_torch.proposal.FlowProposal`.
PROPOSAL_OPTIONS = (
    "reparameterisations",
    "fallback_reparameterisation",
    "use_default_reparameterisations",
    "reverse_reparameterisations",
)


def check_reference_options(options: dict) -> None:
    """Accept the JAX sampler's options where they hold the value the
    port runs with; raise ``NotImplementedError`` naming the ROADMAP item
    for any other value and for the flow proposal's options that the
    port does not take (item 6). The options of
    :data:`PROPOSAL_OPTIONS` are not checked here."""
    for name, value in options.items():
        if name in PROPOSAL_OPTIONS:
            continue
        if name in FIXED_OPTIONS:
            fixed, item = FIXED_OPTIONS[name]
            if _is_fixed(value, fixed):
                continue
            raise NotImplementedError(
                f"{name}={value!r} is not in the PyTorch port's standard sampler yet "
                f"(ROADMAP §1 item {item}); it runs with {name}={fixed!r}"
            )
        raise NotImplementedError(
            f"The flow proposal option {name}={value!r} is not in the PyTorch port "
            "yet (ROADMAP §1 item 6)"
        )


class NestedSampler(BaseNestedSampler):
    """Standard nested sampler.

    ``device`` (default CUDA) is where the flow trains and the pool is
    populated; the sampling loop itself runs on the host in float64.
    The options of :data:`PROPOSAL_OPTIONS` (``reparameterisations=``
    and its fallback, default and order options) go to the flow
    proposal.
    The flow is trained whenever its pool runs empty, and the run stops
    when the estimated remaining evidence ``dlogZ`` falls to
    :attr:`tolerance`.
    """

    #: stopping tolerance on dlogZ
    tolerance: float = 0.1
    #: switch to the flow proposal when the uninformed proposal's mean
    #: block acceptance falls below this
    uninformed_acceptance_threshold: float = 0.5
    #: draws of the simulated evidence error
    n_simulated_evidence: int = 500

    def __init__(
        self,
        model,
        nlive: int = 2000,
        output: Optional[str] = None,
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
        trace_parameters: Optional[list] = None,
        flow_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        proposal_plots: bool = False,
        n_pool: Optional[int] = None,
        pool=None,
        close_pool: bool = False,
        poolsize: Optional[int] = None,
        device=None,
        **options,
    ):
        check_reference_options(options)
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
        self.checkpoint_on_training = checkpoint_on_training
        #: parameters of the trace plot (by default every model parameter)
        self.trace_parameters = list(trace_parameters) if trace_parameters is not None else list(model.names)
        self.log_evidence_error_simulated = None
        self.state = _NSIntegralState(self.nlive)
        self.condition = np.inf

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
        self.uninformed_sampling = True
        self.training_time = datetime.timedelta()
        self._count_carry = 0

        #: iterations after which the uninformed phase ends regardless
        self.maximum_uninformed = 10 * self.nlive
        self._uninformed_proposal = RejectionProposal(
            self.model, rng=self.rng, poolsize=self.nlive
        )
        self._flow_proposal = FlowProposal(
            self.model,
            flow_config=flow_config,
            training_config=training_config,
            output=os.path.join(self.output, "proposal", ""),
            poolsize=self.nlive if poolsize is None else poolsize,
            plot=proposal_plots,
            rng=self.rng,
            device=self.device,
            **{k: options[k] for k in PROPOSAL_OPTIONS if k in options},
        )
        # the weight files are read only at resume: none without
        # checkpoints
        self._flow_proposal.save_flow_weights = bool(self.checkpointing)
        self.proposal = self._uninformed_proposal

    # ------------------------------------------------------------------
    @property
    def flow_proposal(self):
        return self._flow_proposal

    @property
    def acceptance(self) -> float:
        return self.iteration / max(self.likelihood_calls, 1)

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

    def train_proposal(self) -> None:
        """Train the flow proposal on the current live points."""
        logger.info("Training flow proposal at iteration %s", self.iteration)
        st = datetime.datetime.now()
        self._flow_proposal.train(self.live_points.copy(), plot=self.plot)
        self.training_time += datetime.datetime.now() - st
        self.training_iterations.append(self.iteration)
        self.block_iteration = 0
        self.block_acceptance = 0.0
        self.train_count += 1
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
        one iteration was consumed.
        """
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if not getattr(proposal, "populated", False) or not indices or samples is None:
            return False
        state = self.state
        order = np.asarray(indices[::-1], dtype=np.int64)
        pool_logL = np.ascontiguousarray(samples["logL"][order], dtype=np.float64)
        if not np.all(np.isfinite(pool_logL)):
            return False
        pool_l = pool_logL.tolist()

        n = self.nlive
        R = np.concatenate([self.live_points, samples[order]])
        llogL = np.ascontiguousarray(R["logL"][:n], dtype=np.float64)
        ids = np.arange(n, dtype=np.int64)
        R_it = R["it"]

        logt = -1.0 / n
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

        while cond > tol and j < K:
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
                _sync()
                self.live_points = R[ids]
                self.update_state()
                self.periodically_log_state()

        if not n_done:
            return False
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
        return True

    # ------------------------------------------------------------------
    def check_state(self) -> None:
        """Before each replacement: train at the switch from the
        uninformed proposal and whenever the flow's pool is empty."""
        if self.uninformed_sampling:
            if self.check_proposal_switch():
                self.train_proposal()
        elif not self.proposal.populated:
            self.train_proposal()

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
        draws = self.state.simulate_log_evidence(self.n_simulated_evidence, rng=self.rng)
        self.log_evidence_error_simulated = float(np.std(draws))

    def nested_sampling_loop(self):
        """The main loop. Returns ``(logZ, nested_samples)``."""
        self.sampling_start_time = datetime.datetime.now()
        if not self.initialised:
            self.initialise()
        self._yield_iter = self.yield_sample(self.live_points[0])
        while self.condition > self.tolerance:
            self.check_state()
            if not self._consume_from_pool_batched():
                self.consume_sample()
                self.iteration += 1
                self.block_iteration += 1
                self.update_state()
                self.periodically_log_state()
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
