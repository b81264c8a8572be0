"""One cell of ``portbench`` with the program's own spans and counters
(:mod:`nessai_tpu_torch.utils.profiling`) recorded over its window::

    python3 tools/program_trace.py --workload gw_full.start --seed 7 --seconds 51 --trace 1 [--program 1]

Runs ``portbench.harness.run_cell`` as ``portbench/run.py`` does. With
``--program 1`` (the default) it starts the program's recorder when the
window opens and stops it when the window closes, by wrapping the
harness's ``Recorder.start`` and ``Window`` from outside; nothing of the
benchmark is edited. ``--program 0`` runs the cell as ``run.py`` would,
for the recorder's cost.

The last line of standard output is the harness's result with, under
``program``, what the program's record reads over the window:

- ``likelihood_us_row``: the device time of the ``likelihood`` spans (CUDA
  events) over the rows they evaluated, in microseconds a row;
- ``train_busy_share`` and ``populate_busy_share`` (``--trace 1``): the
  union of the trace's device intervals inside the ``epoch`` spans, or
  inside the ``device_loop`` spans, over those spans' seconds, in percent;
- ``masked_round_share``: the device loop's rounds queued after its
  buffer filled, in percent of the rounds queued;
- ``host_reads_epoch``: the host reads of device values inside the
  ``training`` spans over the ``epoch`` spans;
- ``idle_gaps`` (``--trace 1``): the window's ten longest idle gaps of the
  card, each named by the path of the innermost span that holds its
  midpoint (``run/populate/device_loop/chunk_read``), else ``none``;
- ``idle_gaps_split`` (``--trace 1``): the same gaps, each split by the
  innermost span over each stretch of it, its three largest parts;
- ``spans`` and ``seconds``: the count and seconds of the spans by path,
  and ``counters``, the counters' changes;
- ``marker_launch_us`` (``--trace 1``): how long the launch of the device
  trace's marker took, by which the trace places every kernel early; the
  readings above move the kernels later by it (:func:`device_intervals`).

Each reading is None where the record holds nothing to read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, "portbench", ".cache", "nv"))

__all__ = [
    "merge",
    "busy_share",
    "likelihood_us_row",
    "masked_round_share",
    "host_reads_epoch",
    "label_gaps",
    "split_gaps",
    "readings",
    "device_intervals",
    "recording",
    "main",
]


def merge(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint
    ``(starts, ends)`` lists."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _covered(merged, s, e):
    """Seconds of ``[s, e]`` that the merged intervals cover."""
    starts, ends = merged
    total = 0.0
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(starts) and starts[i] < e:
        total += max(0.0, min(ends[i], e) - max(starts[i], s))
        i += 1
    return total


def _seconds(span):
    return span.start * 1e-9, span.end * 1e-9


def busy_share(trace, name, merged):
    """Percent of the seconds of the spans named ``name`` in which the
    card ran something (``merged``: the trace's device intervals on the
    host's clock, from :func:`merge`)."""
    spans = [_seconds(s) for s in trace.spans if s.name == name]
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    return 100.0 * sum(_covered(merged, s, e) for s, e in spans) / total


def likelihood_us_row(trace):
    """Microseconds of device time a row of the ``likelihood`` spans."""
    timed = [s for s in trace.spans if s.name == "likelihood" and "device_s" in s.attrs]
    rows = sum(s.attrs["rows"] for s in timed)
    if not rows:
        return None
    return 1e6 * sum(s.attrs["device_s"] for s in timed) / rows


def masked_round_share(trace):
    """Percent of the device loop's rounds queued that ran on a full
    buffer."""
    queued = trace.counters.get("device_loop_rounds", 0)
    if not queued:
        return None
    return 100.0 * (queued - trace.counters.get("device_loop_active_rounds", 0)) / queued


def host_reads_epoch(trace):
    """Host reads of device values inside the ``training`` spans over
    their ``epoch`` spans."""
    trainings = {s.id: s for s in trace.spans if s.name == "training"}
    epochs = sum(1 for s in trace.spans if s.name == "epoch" and s.attrs.get("training") in trainings)
    if not epochs:
        return None
    return sum(s.attrs["host_reads"] for s in trainings.values()) / epochs


def label_gaps(trace, gaps, top=10):
    """The ``top`` longest ``(start, end)`` gaps (seconds on the host's
    clock), each named by the path of the innermost span that holds its
    midpoint, else ``"none"``: ``[[path, seconds], ...]``
    (``portbench.trace.label_gaps`` over the program's spans)."""
    from portbench import trace as device_trace

    paths = trace.paths()
    spans = [(paths[s.id], s.start * 1e-9, s.end * 1e-9) for s in trace.spans]
    labelled = device_trace.label_gaps(gaps, spans, top=top)
    return [["none" if name == "host loop" else name, seconds] for name, seconds in labelled]


def split_gaps(trace, gaps, top=10, parts=3):
    """The ``top`` longest ``(start, end)`` gaps, each split by the path
    of the innermost span over each stretch of it (``"none"`` outside
    every span): ``[[seconds, [[path, seconds], ...]], ...]``, the
    ``parts`` largest paths of each gap first."""
    paths = trace.paths()
    spans = [(s.start * 1e-9, s.end * 1e-9, paths[s.id]) for s in trace.spans]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inside = [sp for sp in spans if sp[0] < e and sp[1] > s]
        cuts = sorted({s, e, *(t for sp in inside for t in sp[:2] if s < t < e)})
        by_path = {}
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            holding = [sp for sp in inside if sp[0] <= mid <= sp[1]]
            # spans nest: the innermost is the latest to start, the
            # deepest of those that start together
            path = max(holding, key=lambda sp: (sp[0], sp[2].count("/")))[2] if holding else "none"
            by_path[path] = by_path.get(path, 0.0) + (b - a)
        ranked = sorted(by_path.items(), key=lambda kv: -kv[1])[:parts]
        out.append([e - s, [[path, seconds] for path, seconds in ranked]])
    return out


def readings(trace, kernels=None, window=None):
    """The program's readings of a window (see the module's docstring);
    ``kernels`` the trace's ``(start, end)`` device intervals on the
    host's clock and ``window`` its ``(start, end)``, with ``--trace 1``."""
    from portbench.trace import idle_gaps

    paths = trace.paths()
    spans, seconds = {}, {}
    for s in trace.spans:
        p = paths[s.id]
        spans[p] = spans.get(p, 0) + 1
        seconds[p] = seconds.get(p, 0.0) + (s.end - s.start) * 1e-9
    out = dict(
        likelihood_us_row=likelihood_us_row(trace),
        masked_round_share=masked_round_share(trace),
        host_reads_epoch=host_reads_epoch(trace),
        train_busy_share=None,
        populate_busy_share=None,
        idle_gaps=None,
        idle_gaps_split=None,
        spans=spans,
        seconds=seconds,
        counters=trace.counters,
    )
    if kernels is not None:
        merged = merge(kernels)
        out["train_busy_share"] = busy_share(trace, "epoch", merged)
        out["populate_busy_share"] = busy_share(trace, "device_loop", merged)
        gaps = idle_gaps(kernels, *window)
        out["idle_gaps"] = label_gaps(trace, gaps)
        out["idle_gaps_split"] = split_gaps(trace, gaps)
    return out


def device_intervals(win):
    """The window's device intervals on the host's clock, each moved later
    by the marker's launch: ``portbench.trace`` reads the host's clock
    before it launches its marker, the first launch under a profiler just
    started, which takes tens to hundreds of microseconds, and places
    every kernel early by that launch."""
    shift = win.marker_launch
    return [
        (max(s + shift, win.t0), min(e + shift, win.t_close))
        for _, s, e in win.trace.kernels
        if e + shift > win.t0 and s + shift < win.t_close
    ]


@contextlib.contextmanager
def recording():
    """While the block runs, each window ``portbench.harness.run_cell``
    opens starts the program's recorder and its close stops it; yields
    the list of the windows closed, each with its record as ``program``."""
    from nessai_tpu_torch.utils import profiling
    from portbench import harness
    from portbench.ns import Recorder

    windows = []
    start, window = Recorder.start, harness.Window
    launched = []

    def start_traced(self):
        # the harness starts its device trace just before: the marker's
        # launch has returned
        launched.append(time.perf_counter())
        start(self)
        profiling.start_tracing()

    class TracedWindow(window):
        def __init__(self, rec, trace, *args, **kwargs):
            self.program = profiling.stop_tracing()
            super().__init__(rec, trace, *args, **kwargs)
            self.marker_launch = 0.0 if trace is None else launched[-1] - trace._host_marker
            windows.append(self)

    Recorder.start, harness.Window = start_traced, TracedWindow
    try:
        yield windows
    finally:
        Recorder.start, harness.Window = start, window
        if profiling._recorder is not None:
            # the cell failed inside its window
            profiling.stop_tracing()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    with recording() if args.program else contextlib.nullcontext([]) as windows:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    if windows:
        (win,) = windows
        kernels = None if win.trace is None else device_intervals(win)
        result["program"] = readings(win.program, kernels, (win.t0, win.t_close))
        if kernels is not None:
            result["program"]["marker_launch_us"] = win.marker_launch * 1e6
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
