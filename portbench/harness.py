"""The benchmark of ``nessai_tpu_torch``: one cell of ``BENCHMARK.json``,
set up, measured for a window of seconds, checked and reported.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by name:

- ``configs/<config>.json``: the sizes and the sampler's arguments, with
  the plain reference beside it in ``configs/<config>_ref.py``;
- ``traffic/<traffic>.json``: the sampler, what set-up warms up and
  whether runs follow each other back to back (each run samples from
  the configuration's script seed and its index in the window);
- ``metrics/<metric>.py``: one reader each, with its unit;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.
"""

import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level modules that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "nessai_tpu")

__all__ = [
    "FORBIDDEN",
    "load_spec",
    "load_config",
    "load_reference",
    "load_traffic",
    "load_limits",
    "load_metric",
    "cell_metrics",
    "forbidden_modules",
    "run_cell",
]


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_config(name):
    return _json("configs", f"{name}.json")


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(name):
    """The plain reference beside configuration ``name``."""
    return _module(os.path.join(HERE, "configs", f"{name}_ref.py"), f"portbench_ref_{name}")


def load_traffic(name):
    return _json("traffic", f"{name}.json")


def load_limits(workload):
    return _json("limits", f"{workload}.json")


def load_metric(name):
    """The reader of metric ``name``: a module with ``UNIT`` and
    ``read(window)``, which returns a number or None."""
    return _module(os.path.join(HERE, "metrics", f"{name}.py"), "portbench_metric_" + name.replace(".", "_"))


def cell_metrics(spec, workload, trace):
    """The metrics a cell reports: its end-to-end metrics without
    ``trace``, its per-layer metrics with it."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [
        m
        for m in spec["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _class(path):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


class Window:
    """What the metric readers read: the recorder's window, the device
    trace, the counts and the configuration."""

    def __init__(self, rec, trace, config, setup_s, t_close):
        self.rec = rec
        self.trace = trace
        self.config = config
        self.setup_s = setup_s
        self.t0 = rec.t0
        self.t_end = rec.end
        self.seconds = rec.seconds
        self.t_close = t_close
        self.iterations, self.evaluations = rec.committed()
        self.traced_evaluations = rec.commits[-1][2] if rec.commits else 0
        self.flow_widths = None

    @property
    def traced_seconds(self):
        return self.t_close - self.t0


def _flow_widths(segments):
    """``(width, residual blocks)`` of the coupling nets of the window's
    flow, read from its weights."""
    for fs, _, _ in reversed(segments):
        flow = getattr(fs.ns._flow_proposal, "flow", None)
        if flow is None or flow.flow is None:
            continue
        state = flow.flow.state_dict()
        for k, v in state.items():
            if k.endswith("net.initial.weight"):
                prefix = k[: -len("initial.weight")]
                blocks = {kk[len(prefix) :].split(".")[1] for kk in state if kk.startswith(prefix + "blocks.")}
                return int(v.shape[0]), len(blocks)
    return None


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run_cell(
    workload,
    seed,
    seconds,
    trace,
    device="cuda",
    spec=None,
    config_override=None,
    limits=None,
    t_start=None,
    keep=None,
    warmup=True,
):
    """Set up, measure and check one cell; returns the result's dict.

    ``config_override`` replaces keys of the configuration (the tests'
    small sizes on the CPU); ``device`` is ``"cuda"`` in every measured
    run. ``keep``, a dict, receives the snapshot of the program's
    outputs. ``warmup=False`` skips the warm-up, for readings taken after
    a first run in one process."""
    import torch

    from . import check
    from .ns import Recorder, WindowClosed, instrument, sampler_seed
    from .trace import DeviceTrace, idle_gaps, label_gaps, union_seconds

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    cell = next(c for c in spec["workloads"] if c["name"] == workload)
    config = dict(load_config(cell["config"]), **(config_override or {}))
    traffic = load_traffic(cell["traffic"])
    reference = load_reference(cell["config"])
    limits = load_limits(workload) if limits is None else limits
    model_cls = _class(config["model"])
    kwargs = dict(config["sampler_kwargs"])
    on_card = torch.device(device).type == "cuda"

    rec = Recorder(seconds, rng=np.random.default_rng(np.random.SeedSequence([int(seed), 4])), count_kernels=trace)
    out_root = tempfile.mkdtemp(prefix="portbench-")
    trace_rec = None
    try:
        with instrument(rec):
            # -- set-up: the cell's own shapes, warmed up ------------------
            FlowSampler_ = _class("nessai_tpu_torch.flowsampler:FlowSampler")
            warm = traffic["warmup"]

            def new_run(name, run_seed, **extra):
                return FlowSampler_(
                    model_cls(),
                    output=os.path.join(out_root, name),
                    resume=False,
                    device=device,
                    **dict(kwargs, seed=int(run_seed), **extra),
                )

            if warmup:
                n_warm = int(round(warm["iterations_per_nlive"] * int(kwargs["nlive"])))
                fs = new_run("warmup", warm["seed"], max_iteration=n_warm)
                fs.run(plot=False)
                _log(f"warm-up: {fs.ns.iteration} iterations, {fs.ns.train_count} trainings")
                del fs
            if on_card:
                torch.cuda.synchronize()
            gc.collect()

            # -- the window -------------------------------------------------
            if trace and on_card:
                trace_rec = DeviceTrace()
                trace_rec.start()
            setup_s = time.perf_counter() - t_start
            rec.start()
            index = 0
            base = int(config["script_seed"])
            while time.perf_counter() < rec.end:
                run_seed = base if index == 0 else sampler_seed(base, index)
                fs = new_run(f"run{index}", run_seed)
                rec.begin_segment(fs)
                try:
                    fs.run(plot=False)
                    rec.end_segment(fs.ns)
                except WindowClosed:
                    break
                if not traffic["back_to_back"]:
                    break
                index += 1
            if on_card:
                torch.cuda.synchronize()
            t_close = time.perf_counter()
            if trace_rec is not None:
                trace_rec.stop()

        # -- the metrics ----------------------------------------------------
        win = Window(rec, trace_rec, config, setup_s, t_close)
        win.flow_widths = _flow_widths(rec.segments)
        device_info = dict(platform="gpu" if on_card else "cpu", kind=torch.cuda.get_device_name(0) if on_card else "cpu", count=1)
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
        result = dict(correct=False, attempted=int(win.iterations), failed=0, metrics={}, device=device_info)
        for m in cell_metrics(spec, workload, trace):
            reader = load_metric(m["name"])
            value = reader.read(win)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=float(value), unit=m["unit"])
        if trace_rec is not None:
            intervals = trace_rec.clipped(win.t0, t_close)
            device_info["busy_s"] = union_seconds(intervals)
            device_info["window_s"] = t_close - win.t0
            by_name = trace_rec.seconds_by_name(win.t0, t_close)
            spans = [(n, s, e) for n, s, e, _ in rec.spans]
            result["breakdown"] = dict(
                device_ops=[[n[:120], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                idle_gaps=label_gaps(idle_gaps(intervals, win.t0, t_close), spans, top=10),
            )
        marks = [m for m in (5, 10, 20, 30, 40) if m < seconds] + [seconds]
        by = [max([c[1] for c in rec.commits if c[0] <= win.t0 + m] or [0]) for m in marks]
        _log(
            "iterations committed by " + ", ".join(f"{m:g} s: {n}" for m, n in zip(marks, by))
            + f"; {sum(s[2] - s[1] for s in rec.clipped_spans('checkpoint')):.3f} s in checkpoints"
        )
        _log(
            f"window: {win.iterations} iterations in {seconds} s over {len(rec.segments)} run(s); "
            f"{rec.n_scans} scans, {rec.n_passes} host passes; set-up {setup_s:.3f} s; card {_card() if on_card else 'none'}"
        )

        # -- correct: the program's outputs, then the reference ---------------
        snap = check.snapshot(
            rec.segments, rec.scans, rec.passes, reference.NAMES, seed, training=rec.training, rounds=rec.rounds
        )
        if keep is not None:
            keep["snapshot"] = snap
        rec.segments.clear()
        rec.scans.clear()
        rec.passes.clear()
        rec.scan_shapes.clear()
        rec.rounds.clear()
        rec.training = None
        fs = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        readings = check.program_readings(snap, reference, device, config["training"])
        correct, checks = check.judge(readings, limits)
        result["correct"] = bool(correct)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
