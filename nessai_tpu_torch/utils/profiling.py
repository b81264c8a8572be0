"""Device-time measurement with ``torch.profiler`` (CUPTI).

Counterpart of ``nessai_tpu/utils/profiling.py``. Event timers on the
host clock measure what a caller waits for, which for small kernels is
the launch overhead; the profiler's kernel records give the time the
GPU spent. Run as a script on a GPU machine to trace the flagship runs::

    python -m nessai_tpu_torch.utils.profiling [realnvp] [nsf] [ins] [ins_mixture] \
        [reparam_inversion] [reparam_angle] [ins_hypercube] [lu] [eggbox] [augmented]

It profiles the named runs, by default all ten: the RealNVP flagship,
the neural-spline flagship, the importance nested sampler's flagship,
its Gaussian-mixture configuration (with the final redraw), the
half-Gaussian and angle examples through the reparameterisations, the
importance nested sampler with its neural spline flow on the unit
hypercube (``tails=None``, the Rosenbrock likelihood in 4 dimensions;
its trace holds the GPU alone), the documented RealNVP with LU
linear layers, and the egg-box and augmented-proposal examples (their
traces hold the GPU alone). Each runs
three times in one process: a first run (which also pays for the CUDA
context, the kernel build or load and the library handles), a run
without tracing and a run under the profiler (the mixture's traces the
GPU alone). For each it prints one JSON object with the untraced runs'
times before the traced run, and one at the end: the wall time of each
run, the training times, the GPU time and record count of the traced
run, the GPU busy share of the untraced wall time, the GPU seconds of
each of the port's own kernels, and the kernels that take the most GPU
time, the traced run's training epochs and GPU records per epoch, and
the launches per run of the flagship's own kernels (K1 forward and
backward, or K2 forward and backward). For the importance nested
sampler it also prints the levels and the time in training, in draws,
in the ``update_log_q`` passes, in ``log_prob_all`` and in the final
redraw.
"""

import functools
import json
import subprocess
import sys
import tempfile
import time

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
    "OWN_KERNELS",
    "gpu_kernel_events",
    "event_time_ms",
    "device_time_ms",
    "profile_flagship",
]

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
FLAGSHIP_INS_MIXTURE = dict(
    FLAGSHIP_INS,
    nlive=2000,
    stopping_criterion=["ratio", "ess"],
    tolerance=[0.0, 3000],
    check_criteria="all",
)
FLAGSHIP_INS_MIXTURE_RUN = dict(redraw_samples=True, n_posterior_samples=2000)

#: The standard sampler at its defaults (nlive 2000, a RealNVP of 4 ×
#: [Permutation, AffineCoupling (resnet), ActNorm], 500 epochs at most,
#: patience 20, batches of 1000), seed 1234, as the JAX package's
#: examples run it. The boundary-inversion run of
#: ``examples/half_gaussian.py`` on ``utils.testing.HalfGaussianModel``:
#: x, bounded below at 0 where its density piles up, through
#: ``inversion`` (edge detection, the split inversion), y through
#: ``default`` (``RescaleToBounds`` with live bounds).
FLAGSHIP_REPARAM_INVERSION = dict(
    nlive=2000,
    seed=1234,
    resume=False,
    plot=False,
    checkpointing=False,
    reparameterisations={"x": "inversion", "y": "default"},
)

#: The angle run of ``examples/reparameterisations_example.py`` on
#: ``utils.testing.AngleModel``: theta through ``angle-2pi`` (Cartesian
#: coordinates with an auxiliary chi(2) radius, three prime dimensions),
#: amp through ``default``.
FLAGSHIP_REPARAM_ANGLE = dict(
    FLAGSHIP_REPARAM_INVERSION,
    reparameterisations={"theta": {"reparameterisation": "angle-2pi"}, "amp": "default"},
)


#: The importance nested sampler with a flow on the unit hypercube, as
#: ``examples/importance_nested_sampler/nsf_unit_hypercube.py:77-103``
#: runs it (on ``utils.testing.RosenbrockModel(4)``): nlive 10,000, seed
#: 1234, draws of nlive at every level, no logit map (the flow sees the
#: unit hypercube), a quantile threshold at 0.66, fresh weights every 4
#: levels, and a neural spline flow of 4 × [RQSCoupling (resnet, 2
#: layers of 32 neurons, 8 bins, ``tails=None`` on [0, 1])] with no linear
#: transform and no ActNorm on a uniform base.
FLAGSHIP_INS_HYPERCUBE = dict(
    importance_nested_sampler=True,
    nlive=10000,
    seed=1234,
    resume=False,
    plot=False,
    checkpointing=False,
    draw_constant=True,
    reparameterisation=None,
    threshold_kwargs={"q": 0.66},
    reset_flow=4,
    flow_config=dict(
        n_blocks=4,
        n_neurons=32,
        ftype="nsf",
        distribution="uniform",
        linear_transform=None,
        batch_norm_between_layers=False,
        tail_bound=1.0,
        tails=None,
        num_bins=8,
    ),
)

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
FLAGSHIP_EGGBOX = dict(
    nlive=2000,
    seed=170817,
    resume=False,
    plot=False,
    checkpointing=False,
    reset_flow=8,
)

#: ``examples/augmented_example.py`` as written, on
#: ``utils.testing.BimodalGaussianModel``: seed 1234, the augmented flow
#: proposal with two unit-Gaussian augment dimensions (a 4-D RealNVP with
#: the fixed coupling mask), the standard sampler's defaults otherwise
#: (nlive 2000).
FLAGSHIP_AUGMENTED = dict(
    seed=1234,
    resume=False,
    plot=False,
    checkpointing=False,
    flow_class="augmentedflowproposal",
    augment_dims=2,
)


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
)


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
    return dict(
        card=card,
        first_run_wall_s=first,
        untraced_wall_s=untraced,
        **untraced_times,
        traced_wall_s=traced,
        traced_training_time_s=traced_times["training_time_s"],
        gpu_records=len(events),
        training_epochs=epochs,
        gpu_records_per_epoch=len(events) / epochs if epochs else None,
        gpu_busy_s=busy_s,
        gpu_busy_share_of_untraced_wall=None if busy_s is None else busy_s / untraced,
        logZ=fs.logZ,
        logZ_traced=fs_traced.logZ,
        own_kernel_gpu_s=own,
        top=[
            dict(name=name[:90], count=count, seconds=seconds)
            for name, (count, seconds) in ranked
        ],
    )


def _main(names) -> None:
    """Profile the named runs (all ten by default) and print one JSON
    object for each."""
    from ..ops.coupling import affine_coupling
    from ..ops.rqs import rqs
    from .testing import (
        AngleModel,
        BimodalGaussianModel,
        EggboxModel,
        GaussianMixture,
        HalfGaussianModel,
        RosenbrockModel,
    )

    k1, k2 = (affine_coupling, "k1"), (rqs, "rqs")
    runs = {
        "realnvp": (dict(config=FLAGSHIP), k1),
        "nsf": (dict(config=FLAGSHIP_NSF), k2),
        "ins": (dict(config=FLAGSHIP_INS), k1),
        # about 2.5 million GPU records: with the CPU's operator records
        # as well, the trace was not read back within 20 minutes on the H100
        "ins_mixture": (
            dict(config=FLAGSHIP_INS_MIXTURE, model=functools.partial(GaussianMixture, 2),
                 run_kwargs=FLAGSHIP_INS_MIXTURE_RUN, trace_cpu=False),
            k1,
        ),
        "reparam_inversion": (dict(config=FLAGSHIP_REPARAM_INVERSION, model=HalfGaussianModel), k1),
        "reparam_angle": (dict(config=FLAGSHIP_REPARAM_ANGLE, model=AngleModel), k1),
        "ins_hypercube": (
            dict(config=FLAGSHIP_INS_HYPERCUBE, model=functools.partial(RosenbrockModel, 4), trace_cpu=False),
            k2,
        ),
        "lu": (dict(config=FLAGSHIP_LU), k1),
        "eggbox": (dict(config=FLAGSHIP_EGGBOX, model=EggboxModel, trace_cpu=False), k1),
        "augmented": (dict(config=FLAGSHIP_AUGMENTED, model=BimodalGaussianModel, trace_cpu=False), k1),
    }
    for name in names or runs:
        kwargs, (wrapper, prefix) = runs[name]
        wrapper.launches = wrapper.backward_launches = 0
        result = profile_flagship(name=name, **kwargs)
        # three runs: first, untraced, traced
        launches = {
            f"{prefix}_launches_per_run": wrapper.launches / 3,
            f"{prefix}_backward_launches_per_run": wrapper.backward_launches / 3,
        }
        print(json.dumps(dict(flagship=name, **result, **launches)), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("profiling the flagship needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _main(sys.argv[1:])
