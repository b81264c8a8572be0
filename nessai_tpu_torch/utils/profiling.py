"""The program's spans and counters, and device-time measurement with
``torch.profiler`` (CUPTI).

Counterpart of ``nessai_tpu/utils/profiling.py``.

**Spans.** :func:`annotate` marks a region of the program at a layer
boundary (a run, a training and its epochs, a populate and its device
loop calls, the likelihood, a commit, a checkpoint)::

    with annotate("populate") as span:
        ...
        span.set(rounds=n)

Tracing is off by default, and then :func:`annotate` hands back one
shared null context: no clock is read, nothing is recorded and no
``record_function`` is opened. Between :func:`start_tracing` and
:func:`stop_tracing` (or inside :func:`tracing`) each span keeps its
name, its id, its parent's id, the id of the run it belongs to, its start
and end on ``time.perf_counter_ns()`` and its attributes; a span under a
populate or a training carries that pool's or training's id (``pool``,
``training``), and every span the host reads of device values made
inside it (``host_reads``). While a ``torch.profiler`` records, each
span also opens a ``record_function`` of its name. A span opened with
``device=True`` records a pair of CUDA events around its work; their
time (``device_s``) is read when tracing stops, never on the way. The
record (:class:`Trace`) is handed back when tracing stops, with the
counters' changes over the traced stretch.

**Counters.** :func:`populate_counters` names the program's always-on
counts: the device populate loop's calls, rounds queued and active,
chunk reads and chained scans, the prior populates on the device, the
scan's launches, the host reads of device values in ``flowmodel``,
``proposal``, ``samplers`` and the model's batch likelihood, and the
rows the device likelihood evaluated.

**Device time.** Event timers on the host clock measure what a caller
waits for, which for small kernels is the launch overhead; the
profiler's kernel records give the time the GPU spent. Run as a script
on a GPU machine to trace the flagship runs::

    python -m nessai_tpu_torch.utils.profiling [realnvp] [nsf] [ins] [ins_mixture] \
        [reparam_inversion] [reparam_angle] [ins_hypercube] [lu] [eggbox] [augmented] \
        [mcmc] [clustering] [gw_basic] [gw_full]

It profiles the named runs, by default all fourteen: the RealNVP flagship,
the neural-spline flagship, the importance nested sampler's flagship,
its Gaussian-mixture configuration (with the final redraw), the
half-Gaussian and angle examples through the reparameterisations, the
importance nested sampler with its neural spline flow on the unit
hypercube (``tails=None``, the Rosenbrock likelihood in 4 dimensions;
its trace holds the GPU alone), the documented RealNVP with LU
linear layers, the egg-box and augmented-proposal examples and the MCMC
example (their traces hold the GPU alone), the RealNVP flagship with
the clustering flow proposal, and the GW examples' basic model (5-D
flow) and full model (12-D flow, to 7000 iterations), their traces the
GPU alone. Each runs three times in one process: a first run (which also pays for the CUDA
context, the kernel build or load and the library handles), a run
without tracing and a run under the profiler (the mixture's traces the
GPU alone). For each it prints one JSON object with the untraced runs'
times before the traced run, and one at the end: the wall time of each
run, the training times, the GPU time and record count of the traced
run, the GPU seconds of
each of the port's own kernels, and the kernels that take the most GPU
time, the traced run's training epochs and GPU records per epoch, and
the launches per run of the flagship's own kernels (K1 forward and
backward, or K2 forward and backward), of the nested-sampling scan and
the counters of :func:`populate_counters` per run beside
them, and the populate's share of the untraced wall. For the importance nested
sampler it also prints the levels and the time in training, in draws,
in the ``update_log_q`` passes, in ``log_prob_all`` and in the final
redraw.
"""

import contextlib
import functools
import importlib
import itertools
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
import types
from typing import NamedTuple, Optional

import torch

__all__ = [
    "FLAGSHIP",
    "FLAGSHIP_NSF",
    "FLAGSHIP_INS",
    "FLAGSHIP_INS_MIXTURE",
    "FLAGSHIP_INS_MIXTURE_RUN",
    "FLAGSHIP_REPARAM_INVERSION",
    "FLAGSHIP_REPARAM_ANGLE",
    "FLAGSHIP_INS_HYPERCUBE",
    "FLAGSHIP_LU",
    "FLAGSHIP_EGGBOX",
    "FLAGSHIP_AUGMENTED",
    "FLAGSHIP_MCMC",
    "FLAGSHIP_CLUSTERING",
    "FLAGSHIP_GW_BASIC",
    "FLAGSHIP_GW_FULL",
    "OWN_KERNELS",
    "Span",
    "Trace",
    "counts",
    "populate_counters",
    "gpu_kernel_events",
    "event_time_ms",
    "device_time_ms",
    "profile_flagship",
    "profile_region",
    "annotate",
    "start_tracing",
    "stop_tracing",
    "tracing",
]

logger = logging.getLogger(__name__)

#: The flagship configuration of ``bench.py`` (lines 51-63): the 2-D
#: unit Gaussian of ``IntegrationTestModel(2)`` with nlive = 1000 and a
#: RealNVP of 4 × [Permutation, AffineCoupling (resnet), ActNorm].
FLAGSHIP = dict(
    nlive=1000,
    seed=1234,
    resume=False,
    plot=False,
    checkpointing=False,
    flow_config=dict(n_blocks=4, n_neurons="auto", n_layers=2),
    training_config=dict(max_epochs=100, patience=20, batch_size=1000),
    poolsize=1000,
)

#: The neural-spline flagship: the same run with the JAX package's NSF
#: defaults (``nessai_tpu/flows/nsf.py:18-34``), 4 × [Permutation,
#: RQSCoupling (resnet, 8 bins, linear tails on [-5, 5])] and no ActNorm.
FLAGSHIP_NSF = dict(
    FLAGSHIP,
    flow_config=dict(ftype="nsf", n_blocks=4, n_neurons="auto", n_layers=2),
)


#: The importance nested sampler's flagship, as
#: ``benchmarks/ins_calibration.py`` runs it: ``IntegrationTestModel(2)``,
#: nlive = 1000, and everything else at the defaults (entropy threshold,
#: ratio criterion at 0, min_samples 500, i.i.d. live points, a fresh
#: RealNVP of 4 × [Permutation, AffineCoupling (resnet, 2 layers of
#: 4 neurons), ActNorm] per level on logit-space samples, 500 epochs at
#: most with patience 20, batches of 1000).
FLAGSHIP_INS = dict(
    importance_nested_sampler=True,
    nlive=1000,
    seed=1234,
    resume=False,
    plot=False,
    checkpointing=False,
)

#: The importance nested sampler on the Gaussian mixture with ESS-based
#: stopping, as ``examples/importance_nested_sampler/ins_gaussian_mixture.py``
#: runs it: ``GaussianMixture(2)``, nlive = 2000, seed 1234, the ratio
#: criterion at 0 and an ESS of 3000, both to be met, everything else at
#: the defaults (a fresh RealNVP of 4 × [Permutation, AffineCoupling
#: (resnet), ActNorm] per level); ``fs.run(**FLAGSHIP_INS_MIXTURE_RUN)``
#: redraws to a posterior ESS of 2000.
#: (``FLAGSHIP_INS_MIXTURE``, ``FLAGSHIP_INS_MIXTURE_RUN``)

#: The standard sampler at its defaults (nlive 2000, a RealNVP of 4 ×
#: [Permutation, AffineCoupling (resnet), ActNorm], 500 epochs at most,
#: patience 20, batches of 1000), seed 1234, as the JAX package's
#: examples run it. The boundary-inversion run of
#: ``examples/half_gaussian.py`` on ``utils.testing.HalfGaussianModel``:
#: x, bounded below at 0 where its density piles up, through
#: ``inversion`` (edge detection, the split inversion), y through
#: ``default`` (``RescaleToBounds`` with live bounds).
#: (``FLAGSHIP_REPARAM_INVERSION``)

#: The angle run of ``examples/reparameterisations_example.py`` on
#: ``utils.testing.AngleModel``: theta through ``angle-2pi`` (Cartesian
#: coordinates with an auxiliary chi(2) radius, three prime dimensions),
#: amp through ``default``. (``FLAGSHIP_REPARAM_ANGLE``)


#: The importance nested sampler with a flow on the unit hypercube, as
#: ``examples/importance_nested_sampler/nsf_unit_hypercube.py:77-103``
#: runs it (on ``utils.testing.RosenbrockModel(4)``): nlive 10,000, seed
#: 1234, draws of nlive at every level, no logit map (the flow sees the
#: unit hypercube), a quantile threshold at 0.66, fresh weights every 4
#: levels, and a neural spline flow of 4 × [RQSCoupling (resnet, 2
#: layers of 32 neurons, 8 bins, ``tails=None`` on [0, 1])] with no linear
#: transform and no ActNorm on a uniform base.
#: (``FLAGSHIP_INS_HYPERCUBE``)

#: The documented flow configuration of
#: ``docs/normalising-flows-configuration.md:52-66`` (a RealNVP of 4 ×
#: [Permutation, LULinear, AffineCoupling (resnet, 2 layers of 16
#: neurons), ActNorm], lr 3e-3, batches of 1000, 500 epochs at most,
#: patience 20) on ``IntegrationTestModel(2)``, nlive 1000, seed 1234.
FLAGSHIP_LU = dict(
    nlive=1000,
    seed=1234,
    resume=False,
    plot=False,
    checkpointing=False,
    flow_config=dict(n_blocks=4, n_layers=2, n_neurons=16, linear_transform="lu"),
    training_config=dict(lr=3e-3, batch_size=1000, max_epochs=500, patience=20),
)


#: ``examples/eggbox.py`` as written, on ``utils.testing.EggboxModel(2)``:
#: nlive 2000, seed 170817, a full reset of the flow (weights and
#: permutations) at every 8th training, the standard sampler's defaults
#: otherwise (a RealNVP of 4 × [Permutation, AffineCoupling (resnet),
#: ActNorm], 500 epochs at most, patience 20, batches of 1000, the latent
#: radius at 95% of the latent mass).
#: (``FLAGSHIP_EGGBOX``)

#: ``examples/augmented_example.py`` as written, on
#: ``utils.testing.BimodalGaussianModel``: seed 1234, the augmented flow
#: proposal with two unit-Gaussian augment dimensions (a 4-D RealNVP with
#: the fixed coupling mask), the standard sampler's defaults otherwise
#: (nlive 2000).
#: (``FLAGSHIP_AUGMENTED``)

#: ``examples/mcmc_example.py`` as written, on
#: ``utils.testing.GaussianModel`` (host likelihood and prior): seed 1234,
#: the MCMC flow proposal with 20 differential-evolution steps a populate,
#: the standard sampler's defaults otherwise (nlive 2000, a RealNVP of
#: 4 × [Permutation, AffineCoupling (resnet, 2 layers of 4 neurons),
#: ActNorm], 500 epochs at most, patience 20).
#: (``FLAGSHIP_MCMC``)

#: The RealNVP flagship with the clustering flow proposal at the JAX
#: package's default of 8 clusters: every coupling's net takes the
#: one-hot cluster label as its context.
FLAGSHIP_CLUSTERING = dict(FLAGSHIP, flow_class="clusteringflowproposal", max_clusters=8)

#: ``examples/gw/basic_gw_example.py`` as written: the frequency-domain
#: inspiral in two detectors, nlive 1000, seed 170817, angle-2pi on the
#: phase (a 5-D flow), the data through ``torch_likelihood_data``
#: (``FLAGSHIP_GW_BASIC``)

#: the iteration at which ``gw_full`` stops here and in ``chip_smoke.py``
#: (in full the run took 1202 s on the H100), past its third training
GW_FULL_PROFILE_ITERATIONS = 7000

#: ``examples/gw/full_gw_example.py`` as written: 9 parameters with sky
#: location, nlive 2000, seed 150914, a 6 x 32 RealNVP on 12 prime
#: dimensions (angle-2pi, angle-pi and the angle pair)
#: (``FLAGSHIP_GW_FULL``)

#: The configurations above that an example script holds: name ->
#: (module of ``nessai_tpu_torch.examples``, attribute). Each is made at
#: its first use (:func:`__getattr__`), so that the program's modules
#: import this one without the examples; a sampler's keyword arguments
#: gain ``resume=False, plot=False, checkpointing=False``.
_FROM_EXAMPLES = {
    "FLAGSHIP_INS_MIXTURE": ("importance_nested_sampler.ins_gaussian_mixture", "SAMPLER_KWARGS"),
    "FLAGSHIP_INS_MIXTURE_RUN": ("importance_nested_sampler.ins_gaussian_mixture", "RUN_KWARGS"),
    "FLAGSHIP_REPARAM_INVERSION": ("half_gaussian", "SAMPLER_KWARGS"),
    "FLAGSHIP_REPARAM_ANGLE": ("reparameterisations_example", "SAMPLER_KWARGS"),
    "FLAGSHIP_INS_HYPERCUBE": ("importance_nested_sampler.nsf_unit_hypercube", "SAMPLER_KWARGS"),
    "FLAGSHIP_EGGBOX": ("eggbox", "SAMPLER_KWARGS"),
    "FLAGSHIP_AUGMENTED": ("augmented_example", "SAMPLER_KWARGS"),
    "FLAGSHIP_MCMC": ("mcmc_example", "SAMPLER_KWARGS"),
    "FLAGSHIP_GW_BASIC": ("gw.basic_gw_example", "SAMPLER_KWARGS"),
    "FLAGSHIP_GW_FULL": ("gw.full_gw_example", "SAMPLER_KWARGS"),
}


def __getattr__(name):
    """A configuration of :data:`_FROM_EXAMPLES`, made at its first use."""
    if name not in _FROM_EXAMPLES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _FROM_EXAMPLES[name]
    value = dict(getattr(importlib.import_module(f"..examples.{module}", __package__), attr))
    if attr == "SAMPLER_KWARGS":
        value.update(resume=False, plot=False, checkpointing=False)
    globals()[name] = value
    return value


@contextlib.contextmanager
def profile_region(logdir: str, enabled: bool = True):
    """Trace the enclosed region with ``torch.profiler`` (the CPU and,
    where there is one, the GPU) and write its Chrome trace to
    ``logdir/trace.json``; with ``enabled=False`` nothing is traced, so a
    caller can pass a flag through without branching::

        with profile_region("outdir/profile"):
            fs.run()
    """
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        logger.info("torch.profiler trace started (logdir=%s)", logdir)
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("torch.profiler trace written to %s", path)


#: The program's counts since they were last set to 0: host reads of
#: device values (a copy to the host, ``.item()``, ``.tolist()``,
#: ``int()`` of a tensor) in ``flowmodel``, ``proposal``, ``samplers``
#: and the model's batch likelihood, and the rows the model's device
#: likelihood evaluated.
counts = types.SimpleNamespace(host_reads=0, likelihood_rows=0)


class Span(NamedTuple):
    """A span of a trace: ``start`` and ``end`` in nanoseconds of
    ``time.perf_counter_ns()``; ``run`` the id of the run it belongs to
    (None outside a run); ``attrs`` its attributes, with ``pool`` and
    ``training`` taken from its ancestors, ``host_reads`` and, for a
    device span, ``device_s``."""

    name: str
    id: int
    parent: Optional[int]
    run: Optional[int]
    start: int
    end: int
    attrs: dict


class Trace:
    """What tracing recorded: the spans, in the order they ended, and
    each counter's change over the traced stretch by name."""

    def __init__(self, spans=(), counters=None):
        self.spans = list(spans)
        self.counters = dict(counters or {})

    def paths(self) -> dict:
        """Each span's path from its root, by id: ``"run/populate/device_loop"``."""
        by_id = {s.id: s for s in self.spans}
        out = {}

        def path(span):
            if span.id not in out:
                parent = by_id.get(span.parent)
                out[span.id] = span.name if parent is None else path(parent) + "/" + span.name
            return out[span.id]

        for s in self.spans:
            path(s)
        return out


class _NullSpan:
    """The span while tracing is off: it records nothing."""

    __slots__ = ()
    id = None
    run = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        pass


_NULL_SPAN = _NullSpan()

#: attributes a span takes from its parent where it is not given them
_INHERITED = ("pool", "training")


class _Recorder:
    """The spans of one stretch of tracing: those ended, those open, the
    CUDA events to read and the counters at the start."""

    def __init__(self):
        self.spans = []
        self.open = []
        self.events = []
        self.ids = itertools.count(1)
        self.counters = {k: getattr(obj, attr) for k, (obj, attr) in populate_counters().items()}
        self.stopped = False


class _OpenSpan:
    """A span while tracing is on."""

    __slots__ = ("rec", "name", "id", "parent", "run", "start", "attrs", "device", "reads", "function", "events")

    def __init__(self, rec, name, device, attrs):
        self.rec = rec
        self.name = name
        self.device = device
        self.attrs = attrs
        self.function = self.events = None

    def __enter__(self):
        rec = self.rec
        parent = rec.open[-1] if rec.open else None
        self.id = next(rec.ids)
        self.parent = None if parent is None else parent.id
        self.run = self.attrs.pop("run", None if parent is None else parent.run)
        if parent is not None:
            for key in _INHERITED:
                if key in parent.attrs:
                    self.attrs.setdefault(key, parent.attrs[key])
        rec.open.append(self)
        if torch.autograd._profiler_enabled():
            self.function = torch.profiler.record_function(self.name)
            self.function.__enter__()
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.reads = counts.host_reads
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        if self.events is not None:
            self.events[1].record()
        if self.function is not None:
            self.function.__exit__(*exc)
        if self in rec.open:
            del rec.open[rec.open.index(self) :]
        if rec.stopped:
            return None
        self.attrs["host_reads"] = counts.host_reads - self.reads
        rec.spans.append(Span(self.name, self.id, self.parent, self.run, self.start, end, self.attrs))
        if self.events is not None:
            rec.events.append((len(rec.spans) - 1, *self.events))
        return None

    def set(self, **attrs):
        """Add attributes (``run`` sets the span's run)."""
        if "run" in attrs:
            self.run = attrs.pop("run")
        self.attrs.update(attrs)


#: the recorder while tracing is on, else None
_recorder = None


def annotate(name: str, device: bool = False, **attrs):
    """The span ``name`` around a region of the program, with attributes
    ``attrs`` (``run=`` sets the run a root span belongs to); ``device``
    also times the device's work in the span with CUDA events. With
    tracing off, one shared null context::

        with annotate("device_loop") as span:
            ...
            span.set(rounds=rounds)
    """
    if _recorder is None:
        return _NULL_SPAN
    return _OpenSpan(_recorder, name, device, attrs)


def start_tracing() -> None:
    """Record every span from now on, and the counters' changes."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("tracing is already on")
    _recorder = _Recorder()


def stop_tracing() -> Trace:
    """Stop recording and hand back the record: the spans that ended
    (spans still open are left out), each device span's ``device_s``
    read from its CUDA events, and the counters' changes."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is None:
        raise RuntimeError("tracing is not on")
    rec.stopped = True
    for i, start, end in rec.events:
        end.synchronize()
        rec.spans[i].attrs["device_s"] = start.elapsed_time(end) * 1e-3
    now = {k: getattr(obj, attr) for k, (obj, attr) in populate_counters().items()}
    return Trace(rec.spans, {k: v - rec.counters.get(k, 0) for k, v in now.items()})


@contextlib.contextmanager
def tracing():
    """Trace the enclosed block; the :class:`Trace` it yields is filled
    when the block ends::

        with tracing() as trace:
            fs.run()
        trace.spans
    """
    start_tracing()
    trace = Trace()
    try:
        yield trace
    finally:
        done = stop_tracing()
        trace.spans, trace.counters = done.spans, done.counters


def gpu_kernel_events(prof):
    """The GPU activity records of a finished profile (kernels, copies,
    memsets), without the user-annotation ranges the optimisers add."""
    return [
        e
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]


def _profile(cpu: bool = True):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    return profile(activities=activities)


def event_time_ms(fn, calls: int = 200, warmup: int = 5):
    """Time per call of ``fn`` between two CUDA events around ``calls``
    back-to-back calls: the GPU time plus the gaps the host leaves
    between launches, so at least the GPU time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_time_ms(fn, calls: int = 200, warmup: int = 5):
    """GPU time per call of ``fn``: the summed duration of the GPU work
    that ``calls`` calls launch. Returns ``(ms per call, GPU records per
    call, timer)`` with timer ``"torch.profiler"``. Where the profiler
    records no GPU work (CUPTI tracing is not available to the process,
    as when another tool already subscribes to it), the time is
    ``event_time_ms`` over the same calls instead, the records per call
    are None and the timer is ``"cuda_events"``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with _profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = gpu_kernel_events(prof)
    if not events:
        return event_time_ms(fn, calls, warmup=0), None, "cuda_events"
    ms = sum(e.device_time_total for e in events) / calls / 1e3
    return ms, len(events) / calls, "torch.profiler"


def phase_times(fs) -> dict:
    """Wall seconds of a finished run's phases and its training epochs
    (and, for the importance nested sampler, its levels)."""
    ns = fs.ns
    if fs.importance_nested_sampler:
        flow = ns.proposal.flow
        return dict(
            levels=flow.n_models,
            training_time_s=ns.training_time.total_seconds(),
            draw_time_s=ns.draw_samples_time.total_seconds(),
            update_log_q_time_s=ns.update_log_q_time.total_seconds(),
            log_prob_all_time_s=flow.log_prob_all_time.total_seconds(),
            redraw_time_s=ns.draw_final_samples_time.total_seconds(),
            training_epochs=len(flow.history["loss"]),
        )
    return dict(
        training_time_s=ns.training_time.total_seconds(),
        population_time_s=ns.flow_proposal.population_time.total_seconds(),
        training_epochs=len(ns.flow_proposal.flow.history["loss"]),
    )


def _run_flagship(output, config, model=None, run_kwargs=None):
    from ..flowsampler import FlowSampler
    from .testing import IntegrationTestModel

    model = IntegrationTestModel(2) if model is None else model()
    fs = FlowSampler(model, output=output, device="cuda", **config)
    fs.run(plot=False, save=False, **(run_kwargs or {}))
    torch.cuda.synchronize()
    return fs


#: The port's own kernels, by a part of their names in the trace.
OWN_KERNELS = (
    "affine_coupling_kernel",
    "affine_coupling_backward_kernel",
    "rqs_forward_kernel",
    "rqs_backward_kernel",
    "ns_scan_register_kernel",
    "ns_scan_kernel",
)


def populate_counters() -> dict:
    """The program's always-on counts by name: the flow proposal's
    device loop (calls, rounds queued, rounds active, host reads of its
    count, scans chained on), the prior populate on the device
    (populates, scans chained on), the scan kernel's launches, the host
    reads of device values and the device likelihood's rows
    (:data:`counts`), as ``(object, attribute)``; set each to 0 before a
    run and read it after."""
    from ..ops.ns_scan import ns_scan
    from ..proposal.flowproposal.flowproposal import device_loop_counts
    from ..proposal.rejection import prior_populate_counts

    return {
        "device_loop_calls": (device_loop_counts, "calls"),
        "device_loop_rounds": (device_loop_counts, "rounds"),
        "device_loop_active_rounds": (device_loop_counts, "active_rounds"),
        "device_loop_chunk_reads": (device_loop_counts, "chunk_reads"),
        "device_loop_chained_scans": (device_loop_counts, "chained_scans"),
        "prior_device_populates": (prior_populate_counts, "populates"),
        "prior_chained_scans": (prior_populate_counts, "chained_scans"),
        "ns_scan_launches": (ns_scan, "launches"),
        "host_reads": (counts, "host_reads"),
        "likelihood_rows": (counts, "likelihood_rows"),
    }


def profile_flagship(
    top: int = 12, config=FLAGSHIP, model=None, run_kwargs=None, trace_cpu: bool = True, name=None
) -> dict:
    """Time and trace a flagship run (``config``, on the model that
    ``model()`` makes, by default ``IntegrationTestModel(2)``, run with
    ``run_kwargs``) on the
    GPU. The untraced runs' times are printed (as ``name``) before the
    traced run; ``trace_cpu=False`` traces the GPU alone."""
    run = (config, model, run_kwargs)
    with tempfile.TemporaryDirectory(prefix=".profile_", dir=".") as output:
        start = time.perf_counter()
        _run_flagship(output, *run)
        first = time.perf_counter() - start
        start = time.perf_counter()
        fs = _run_flagship(output, *run)
        untraced = time.perf_counter() - start
        untraced_times = {f"untraced_{k}": v for k, v in phase_times(fs).items()}
        print(
            json.dumps(dict(flagship=name, stage="untraced", first_run_wall_s=first, untraced_wall_s=untraced,
                            **untraced_times, logZ=fs.logZ)),
            flush=True,
        )
        with _profile(cpu=trace_cpu) as prof:
            start = time.perf_counter()
            fs_traced = _run_flagship(output, *run)
            traced = time.perf_counter() - start
    events = gpu_kernel_events(prof)
    # None where the profiler recorded no GPU work (no CUPTI tracing)
    busy_s = sum(e.device_time_total for e in events) / 1e6 if events else None
    by_name = {}
    for e in events:
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + e.device_time_total / 1e6)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    own = {
        kernel: dict(
            count=sum(c for name, (c, _) in by_name.items() if kernel in name),
            seconds=sum(t for name, (_, t) in by_name.items() if kernel in name),
        )
        for kernel in OWN_KERNELS
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    traced_times = phase_times(fs_traced)
    # the traced run's epochs: its GPU records per epoch of training
    epochs = traced_times["training_epochs"]
    population = untraced_times.get("untraced_population_time_s")
    return dict(
        card=card,
        first_run_wall_s=first,
        untraced_wall_s=untraced,
        **untraced_times,
        untraced_population_share_of_wall=None if population is None else population / untraced,
        traced_wall_s=traced,
        traced_training_time_s=traced_times["training_time_s"],
        gpu_records=len(events),
        training_epochs=epochs,
        gpu_records_per_epoch=len(events) / epochs if epochs else None,
        gpu_busy_s=busy_s,
        logZ=fs.logZ,
        logZ_traced=fs_traced.logZ,
        own_kernel_gpu_s=own,
        top=[
            dict(name=name[:90], count=count, seconds=seconds)
            for name, (count, seconds) in ranked
        ],
    )


def _main(names) -> None:
    """Profile the named runs (all fourteen by default) and print one JSON
    object for each."""
    from ..examples.gw import basic_gw_example, full_gw_example
    from ..ops.coupling import affine_coupling
    from ..ops.rqs import rqs
    from .testing import (
        AngleModel,
        BimodalGaussianModel,
        EggboxModel,
        GaussianMixture,
        GaussianModel,
        HalfGaussianModel,
        RosenbrockModel,
    )

    flagship = {name: __getattr__(name) for name in _FROM_EXAMPLES}
    k1, k2 = (affine_coupling, "k1"), (rqs, "rqs")
    runs = {
        "realnvp": (dict(config=FLAGSHIP), k1),
        "nsf": (dict(config=FLAGSHIP_NSF), k2),
        "ins": (dict(config=FLAGSHIP_INS), k1),
        # about 2.5 million GPU records: with the CPU's operator records
        # as well, the trace was not read back within 20 minutes on the H100
        "ins_mixture": (
            dict(config=flagship["FLAGSHIP_INS_MIXTURE"], model=functools.partial(GaussianMixture, 2),
                 run_kwargs=flagship["FLAGSHIP_INS_MIXTURE_RUN"], trace_cpu=False),
            k1,
        ),
        "reparam_inversion": (dict(config=flagship["FLAGSHIP_REPARAM_INVERSION"], model=HalfGaussianModel), k1),
        "reparam_angle": (dict(config=flagship["FLAGSHIP_REPARAM_ANGLE"], model=AngleModel), k1),
        "ins_hypercube": (
            dict(config=flagship["FLAGSHIP_INS_HYPERCUBE"], model=functools.partial(RosenbrockModel, 4), trace_cpu=False),
            k2,
        ),
        "lu": (dict(config=FLAGSHIP_LU), k1),
        "eggbox": (dict(config=flagship["FLAGSHIP_EGGBOX"], model=EggboxModel, trace_cpu=False), k1),
        "augmented": (dict(config=flagship["FLAGSHIP_AUGMENTED"], model=BimodalGaussianModel, trace_cpu=False), k1),
        "mcmc": (dict(config=flagship["FLAGSHIP_MCMC"], model=GaussianModel, trace_cpu=False), k1),
        "clustering": (dict(config=FLAGSHIP_CLUSTERING), k1),
        # 1167 epochs: with the CPU's records the trace was not read back
        # within 10 minutes on the H100
        "gw_basic": (dict(config=flagship["FLAGSHIP_GW_BASIC"], model=basic_gw_example.BasicGWModel, trace_cpu=False), k1),
        "gw_full": (
            dict(config=dict(flagship["FLAGSHIP_GW_FULL"], max_iteration=GW_FULL_PROFILE_ITERATIONS),
                 model=full_gw_example.FullGWModel, trace_cpu=False),
            k1,
        ),
    }
    for name in names or runs:
        kwargs, (wrapper, prefix) = runs[name]
        wrapper.launches = wrapper.backward_launches = 0
        counters = populate_counters()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        result = profile_flagship(name=name, **kwargs)
        # three runs: first, untraced, traced
        launches = {
            f"{prefix}_launches_per_run": wrapper.launches / 3,
            f"{prefix}_backward_launches_per_run": wrapper.backward_launches / 3,
            **{f"{key}_per_run": getattr(obj, attr) / 3 for key, (obj, attr) in counters.items()},
        }
        print(json.dumps(dict(flagship=name, **result, **launches)), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("profiling the flagship needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _main(sys.argv[1:])
