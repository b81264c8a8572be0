"""Driving the port's standard nested sampler through a measured window.

The harness wraps a few of the sampler's methods from outside, for the
length of a run, and restores them after:

- ``NestedSampler.check_state``, which the sampling loop calls before
  each step: it notes the time and the iterations committed so far, and
  closes the window by raising :class:`WindowClosed` once the window's
  seconds have passed. An iteration counts where it was committed by the
  window's end.
- ``NestedSampler.train_proposal``, the proposals' ``populate``, the
  device commit and ``checkpoint``: host spans of training (with its
  epochs), populating, committing a scanned pool and checkpointing.
- ``samplers.ns_device.ns_scan``, every consume/insert scan: its inputs
  and outputs, kept on the device, for the check of the ordering and for
  the scan's roofline; and ``NestedSampler._consume_from_pool_batched``,
  the host pass that consumes a pool where no scan was chained on: the
  live set and the pool before it, and the dead points and insertion
  indices it committed (host copies of a few thousand numbers a pass).
- ``FlowModel.train`` and ``FlowModel._train_step``: of one training of
  the window, drawn from the recorder's generator, the flow's weights,
  the optimiser's moments and the batches of its first ``train_steps``
  steps, the moments after the first and the weights after the last
  (device copies; the replay of :mod:`.reference.adamw` judges them);
- ``FlowProposal._device_loop_round``: of a few first rounds of the
  device populate loop's calls, drawn from the recorder's generator, the
  round's generator state, its constants (the draw count, the latent
  radius, the temperature), the flow's weights, the affine rescalings
  and the rows it accepted (for :mod:`.reference.populate`);
- with ``count_kernels``, ``flows.bijectors.affine_coupling_layer``: the
  shapes of every coupling kernel launch and whether a backward follows.

Nothing of the program is edited.
"""

import contextlib
import time

import numpy as np
import torch

__all__ = ["WindowClosed", "Recorder", "instrument", "sampler_seed"]


class WindowClosed(Exception):
    """The window's seconds have passed."""


def sampler_seed(seed, index):
    """The sampler's seed of run ``index`` of a window, from the seed
    ``seed`` of the window's first run."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])


class Recorder:
    """What a window saw: commits on the host clock, spans, kernel shapes,
    scans and host passes, a training and a few populate rounds."""

    #: the optimiser steps recorded of the training kept
    train_steps = 3
    #: the first rounds of device-loop calls kept
    keep_rounds = 4

    def __init__(self, seconds, rng=None, count_kernels=False, keep_scans=16):
        self.seconds = float(seconds)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.count_kernels = count_kernels
        self.keep_scans = keep_scans
        self.t0 = None
        self.commits = []  # (t, iterations committed, likelihood evaluations)
        self.spans = []  # (name, start, end, epochs)
        self.k1 = {}  # (n, D, n_tr, inverse, backward) -> launches
        self.scans = []  # reservoir: (live, pool, max_accepts, outputs) on the device
        self.passes = []  # reservoir: (live, pool, dead logL, insertion indices) on the host
        self.n_passes = 0
        self.scan_shapes = []  # (n, k, mask, ins) of every scan, with count_kernels
        self.n_scans = 0
        self.segments = []  # (FlowSampler, iteration and evaluations at its start)
        self._base = (0, 0)
        self.training = None  # the training kept: weights, moments, batches
        self.n_trainings = 0
        self._capture = None  # the training being recorded
        self.rounds = []  # reservoir of first rounds of device-loop calls
        self.n_rounds = 0
        self._call_count = None  # the accepted count of the call seen last

    # -- the window --------------------------------------------------
    @property
    def open(self):
        return self.t0 is not None

    @property
    def end(self):
        return self.t0 + self.seconds

    def start(self):
        self.t0 = time.perf_counter()

    def begin_segment(self, fs):
        ns = fs.ns
        self.segments.append((fs, int(ns.iteration), int(ns.model.likelihood_evaluations)))

    def note(self, ns):
        """Record the iterations and evaluations committed now."""
        _, it0, ev0 = self.segments[-1]
        t = time.perf_counter()
        self.commits.append(
            (t, self._base[0] + int(ns.iteration) - it0, self._base[1] + int(ns.model.likelihood_evaluations) - ev0)
        )
        return t

    def end_segment(self, ns):
        self.note(ns)
        self._base = self.commits[-1][1:]

    def committed(self):
        """``(iterations, evaluations)`` committed by the window's end."""
        done = [c for c in self.commits if c[0] <= self.end]
        return done[-1][1:] if done else (0, 0)

    def clipped_spans(self, name=None):
        """Spans, clipped to the window, as ``(name, start, end, epochs)``."""
        out = []
        for n, s, e, epochs in self.spans:
            if name is not None and n != name:
                continue
            if e > self.t0 and s < self.end:
                out.append((n, max(s, self.t0), min(e, self.end), epochs))
        return out

    # -- the scans -----------------------------------------------------
    def keep_scan(self, live, pool, max_accepts, out):
        if not self.open:
            return
        self.n_scans += 1
        if self.count_kernels:
            self.scan_shapes.append((int(live.shape[0]), int(pool.shape[0]), out[0].clone(), out[2].clone()))
        item = (live.clone(), pool.clone(), int(max_accepts), tuple(o.clone() if hasattr(o, "clone") else o for o in out))
        self._keep(self.scans, self.n_scans, item)

    def keep_pass(self, item):
        self.n_passes += 1
        self._keep(self.passes, self.n_passes, item)

    def _keep(self, kept, seen, item, size=None):
        """Reservoir sampling from the recorder's generator."""
        j = self._slot(len(kept), seen, self.keep_scans if size is None else size)
        if j == len(kept):
            kept.append(item)
        elif j is not None:
            kept[j] = item

    def _slot(self, n_kept, seen, size):
        """Where the ``seen``-th item goes in a reservoir of ``size`` that
        holds ``n_kept``: an index, or None where it is not kept."""
        if n_kept < size:
            return n_kept
        j = int(self.rng.integers(seen))
        return j if j < size else None

    # -- a training and populate rounds --------------------------------
    def begin_training(self, model):
        """A training starts: record it where the reservoir of one keeps it."""
        self.n_trainings += 1
        keep = self._slot(0 if self.training is None else 1, self.n_trainings, 1) is not None
        self._capture = dict(model=model, steps=[]) if keep else None

    def end_training(self):
        self._capture = None

    def train_step(self, model, step, x, w, context):
        """Run ``step`` (the program's optimiser step on the batch ``x``),
        recording it where this training is kept."""
        cap = self._capture
        if cap is None or cap["model"] is not model or context is not None:
            return step(model, x, w, context)
        named = {n: p for n, p in model.flow.named_parameters() if p.requires_grad}
        if not cap["steps"]:
            cap["state"] = {k: v.detach().clone() for k, v in model.flow.state_dict().items()}
            cap["before"] = {n: p.detach().clone() for n, p in named.items()}
            cap["moments"] = _moments(model.optimiser, named)
        loss = step(model, x, w, context)
        cap["steps"].append((x.detach().clone(), None if w is None else w.detach().clone(), loss.detach().clone()))
        if len(cap["steps"]) == 1:
            cap["moments1"] = _moments(model.optimiser, named)
        if len(cap["steps"]) == self.train_steps:
            cap["after"] = {n: p.detach().clone() for n, p in named.items()}
            cap.pop("model")
            self.training, self._capture = cap, None
        return loss

    def populate_round(self, proposal, round_, loop, gen, buf_x, count, n_prop):
        """Run ``round_`` (a round of the device populate loop), recording
        it where it is a call's first round that the reservoir keeps."""
        if count is self._call_count:
            return round_(proposal, loop, gen, buf_x, count, n_prop)
        self._call_count = count
        self.n_rounds += 1
        j = self._slot(len(self.rounds), self.n_rounds, self.keep_rounds)
        if j is None:
            return round_(proposal, loop, gen, buf_x, count, n_prop)
        gen_state = gen.get_state().clone()
        out = round_(proposal, loop, gen, buf_x, count, n_prop)
        affine = {}
        for r in proposal._reparameterisation.values():
            a = r.as_affine() if hasattr(r, "as_affine") else None
            affine.update(a or {})
        item = dict(
            gen_state=gen_state,
            B=int(loop.B),
            cap=int(loop.cap),
            r2=float(loop.r2),
            sqrt_t=float(loop.sqrt_t),
            prime=list(proposal.prime_parameters),
            parameters=list(proposal.parameters),
            affine=affine,
            state={k: v.detach().clone() for k, v in proposal.flow.flow.state_dict().items()},
            buf=buf_x.clone(),
            count=count.clone(),
        )
        if j == len(self.rounds):
            self.rounds.append(item)
        else:
            self.rounds[j] = item
        return out


def _span(recorder, name, fn, epochs_of=None):
    def wrapped(self, *args, **kwargs):
        if not recorder.open:
            return fn(self, *args, **kwargs)
        e0 = epochs_of(self) if epochs_of else 0
        s = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            recorder.spans.append((name, s, time.perf_counter(), (epochs_of(self) - e0) if epochs_of else 0))

    return wrapped


def _moments(optimiser, named):
    """Each weight's ``(first moment, second moment, step count)`` in the
    optimiser (zeros before its first step)."""
    out = {}
    for n, p in named.items():
        st = optimiser.state.get(p, {})
        if "exp_avg" in st:
            out[n] = (st["exp_avg"].detach().clone(), st["exp_avg_sq"].detach().clone(), int(st["step"]))
        else:
            out[n] = (torch.zeros_like(p), torch.zeros_like(p), 0)
    return out


def _epochs(ns):
    flow = getattr(ns._flow_proposal, "flow", None)
    return len(flow.history["loss"]) if flow is not None else 0


@contextlib.contextmanager
def instrument(recorder):
    """Wrap the sampler's methods for ``recorder`` while the block runs."""
    from nessai_tpu_torch.flowmodel.base import FlowModel
    from nessai_tpu_torch.flows import bijectors
    from nessai_tpu_torch.proposal.flowproposal.flowproposal import FlowProposal
    from nessai_tpu_torch.proposal.rejection import RejectionProposal
    from nessai_tpu_torch.samplers import ns_device
    from nessai_tpu_torch.samplers.nestedsampler import NestedSampler

    saved = [
        (NestedSampler, "check_state", NestedSampler.check_state),
        (NestedSampler, "train_proposal", NestedSampler.train_proposal),
        (NestedSampler, "_consume_from_pool_device", NestedSampler._consume_from_pool_device),
        (NestedSampler, "_consume_from_pool_batched", NestedSampler._consume_from_pool_batched),
        (NestedSampler, "checkpoint", NestedSampler.checkpoint),
        (FlowProposal, "populate", FlowProposal.populate),
        (FlowProposal, "_device_loop_round", FlowProposal._device_loop_round),
        (FlowModel, "train", FlowModel.train),
        (FlowModel, "_train_step", FlowModel._train_step),
        (RejectionProposal, "populate", RejectionProposal.populate),
        (ns_device, "ns_scan", ns_device.ns_scan),
        (bijectors, "affine_coupling_layer", bijectors.affine_coupling_layer),
    ]
    check_state = NestedSampler.check_state
    train = FlowModel.train
    train_step = FlowModel._train_step
    round_ = FlowProposal._device_loop_round
    scan = ns_device.ns_scan
    coupling = bijectors.affine_coupling_layer

    def check_state_hook(self, *args, **kwargs):
        if recorder.open and recorder.segments and recorder.segments[-1][0].ns is self:
            if recorder.note(self) >= recorder.end:
                raise WindowClosed()
        return check_state(self, *args, **kwargs)

    def train_hook(self, *args, **kwargs):
        if not recorder.open:
            return train(self, *args, **kwargs)
        recorder.begin_training(self)
        try:
            return train(self, *args, **kwargs)
        finally:
            recorder.end_training()

    def train_step_hook(self, x, w=None, context=None):
        if not recorder.open:
            return train_step(self, x, w, context)
        return recorder.train_step(self, train_step, x, w, context)

    def round_hook(self, loop, gen, buf_x, count, n_prop):
        if not recorder.open:
            return round_(self, loop, gen, buf_x, count, n_prop)
        return recorder.populate_round(self, round_, loop, gen, buf_x, count, n_prop)

    batched = NestedSampler._consume_from_pool_batched

    def batched_hook(self):
        proposal = self.proposal
        indices = getattr(proposal, "indices", None)
        samples = getattr(proposal, "samples", None)
        if not (recorder.open and getattr(proposal, "populated", False) and indices and samples is not None):
            return batched(self)
        order = np.asarray(indices[::-1], dtype=np.int64)
        pool = np.array(samples["logL"][order], dtype=np.float64)
        live = np.array(self.live_points["logL"], dtype=np.float64)
        n0, i0 = len(self.nested_samples), len(self.insertion_indices)
        done = batched(self)
        if done:
            dead = np.array([float(x["logL"]) for x in self.nested_samples[n0:]], dtype=np.float64)
            recorder.keep_pass((live, pool, dead, np.array(self.insertion_indices[i0:], dtype=np.int64)))
        return done

    def scan_hook(live, pool, max_accepts):
        out = scan(live, pool, max_accepts)
        recorder.keep_scan(live, pool, max_accepts, out)
        return out

    def coupling_hook(x, out, transform_idx, inverse=False, clamp=5.0):
        if recorder.open:
            import torch

            backward = torch.is_grad_enabled() and (x.requires_grad or out.requires_grad)
            key = (int(x.shape[0]), int(x.shape[1]), int(transform_idx.numel()), bool(inverse), bool(backward))
            recorder.k1[key] = recorder.k1.get(key, 0) + 1
        return coupling(x, out, transform_idx, inverse, clamp)

    NestedSampler.check_state = check_state_hook
    FlowModel.train = train_hook
    FlowModel._train_step = train_step_hook
    FlowProposal._device_loop_round = round_hook
    NestedSampler.train_proposal = _span(recorder, "training", NestedSampler.train_proposal, _epochs)
    NestedSampler._consume_from_pool_device = _span(recorder, "commit", NestedSampler._consume_from_pool_device)
    NestedSampler._consume_from_pool_batched = _span(recorder, "commit", batched_hook)
    NestedSampler.checkpoint = _span(recorder, "checkpoint", NestedSampler.checkpoint)
    FlowProposal.populate = _span(recorder, "populate", FlowProposal.populate)
    RejectionProposal.populate = _span(recorder, "populate", RejectionProposal.populate)
    ns_device.ns_scan = scan_hook
    if recorder.count_kernels:
        bijectors.affine_coupling_layer = coupling_hook
    try:
        yield recorder
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
