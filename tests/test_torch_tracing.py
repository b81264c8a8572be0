"""The program's spans and counters (``nessai_tpu_torch.utils.profiling``)
on the CPU: with tracing off a run records nothing; with it on, the span
tree of a small run through the device populate loop, its ids and its
counters; and the readings that ``tools/program_trace.py`` takes of a
record, on synthetic records."""

import collections
import subprocess
import sys
import types

import pytest
import torch

from nessai_tpu_torch.utils import profiling
from nessai_tpu_torch.utils.profiling import Span, Trace, annotate

#: a small run of the standard sampler through the device populate loop
#: with the scan chained on, checkpointing on
RUN_KWARGS = dict(
    resume=False,
    seed=1,
    nlive=100,
    device="cpu",
    plot=False,
    checkpointing=True,
    max_iteration=600,
    populate_mode="device_loop",
    flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
    training_config=dict(max_epochs=5, batch_size=64, patience=3),
)


def _run(output):
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    fs = FlowSampler(IntegrationTestModel(2), output=str(output), **RUN_KWARGS)
    fs.run(plot=False)
    return fs


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced run, with the ``(B, proposals)`` of each device loop call."""
    from nessai_tpu_torch.proposal.flowproposal.flowproposal import FlowProposal

    calls = []
    call = FlowProposal._device_loop_call

    def recorded(self, seed, rounds, B, *args, **kwargs):
        out = call(self, seed, rounds, B, *args, **kwargs)
        calls.append((B, out[3]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FlowProposal, "_device_loop_call", recorded)
        with profiling.tracing() as trace:
            fs = _run(tmp_path_factory.mktemp("traced"))
    return types.SimpleNamespace(fs=fs, trace=trace, calls=calls, paths=trace.paths())


def test_tracing_off_records_nothing_and_opens_no_record_function(tmp_path, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("called with tracing off")

    # as if a profiler were recording: with tracing off the spans must not
    # look, read a clock, time the device or record
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=refused))
    monkeypatch.setattr(profiling, "_OpenSpan", refused)
    fs = _run(tmp_path)
    assert fs.ns.iteration >= 600
    assert profiling._recorder is None
    assert fs.run_id is None and fs.ns.proposal.pool_id is None
    assert annotate("a") is annotate("b", device=True, rows=3)
    with annotate("a") as span:
        span.set(rows=1)
    assert span.id is None


#: paths every traced run of ``RUN_KWARGS`` makes, below its ``setup`` and ``run``
EXPECTED_PATHS = {
    "setup",
    "run",
    "run/initialise",
    "run/training",
    "run/training/epoch",
    "run/training/epoch/train_step",
    "run/training/epoch/validation",
    "run/training/epoch/state_copy",
    "run/training/save_weights",
    "run/populate",
    "run/populate/device_loop",
    "run/populate/device_loop/chunk_read",
    "run/populate/device_loop/likelihood",
    "run/populate/device_loop/scan",
    "run/populate/device_loop/pool_to_host",
    "run/commit",
    "run/commit/evidence_replay",
    "run/commit/history",
    "run/finalise",
    "run/finalise/checkpoint",
    "run/posterior",
    "run/result_write",
}


def test_span_tree_of_a_device_loop_run(traced):
    spans, paths = traced.trace.spans, traced.paths
    assert EXPECTED_PATHS <= set(paths.values())
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start <= s.end
        if s.parent is None:
            assert s.name in ("setup", "run"), paths[s.id]
            continue
        parent = by_id[s.parent]
        assert parent.start <= s.start and s.end <= parent.end, paths[s.id]
    # spans are kept in the order they ended
    assert [s.end for s in spans] == sorted(s.end for s in spans)
    # an epoch's index counts up within its training
    for t in (s for s in spans if s.name == "training"):
        epochs = [s for s in spans if s.name == "epoch" and s.parent == t.id]
        assert [e.attrs["index"] for e in epochs] == list(range(len(epochs)))


def test_run_training_and_pool_ids_are_consistent(traced):
    spans, fs = traced.trace.spans, traced.fs
    by_id = {s.id: s for s in spans}
    (setup,) = [s for s in spans if s.name == "setup"]
    assert setup.id == setup.run == fs.run_id
    assert all(s.run == fs.run_id for s in spans)

    def ancestor(span, name):
        while span is not None and span.name != name:
            span = by_id.get(span.parent)
        return span

    # a training's and a pool's spans carry its id; a commit carries the
    # id of the pool it commits, and so do the spans under it
    for s in spans:
        training, pool, commit = (ancestor(s, name) for name in ("training", "populate", "commit"))
        assert s.attrs.get("training") == (training and training.id), s
        assert s.attrs.get("pool") == (pool.id if pool else commit and commit.attrs["pool"]), s
    pools = {s.id: s for s in spans if s.name == "populate"}
    commits = [s for s in spans if s.name == "commit"]
    assert commits and all(s.attrs["iterations"] >= 0 for s in commits)
    for c in commits:
        assert c.attrs["pool"] in pools
        assert pools[c.attrs["pool"]].end <= c.start
    assert sum(c.attrs["iterations"] for c in commits) <= fs.ns.iteration
    assert fs.ns.proposal.pool_id == max(pools)


def test_counters_agree_with_the_spans_and_the_loop(traced):
    spans, counters, calls = traced.trace.spans, traced.trace.counters, traced.calls
    named = collections.defaultdict(list)
    for s in spans:
        named[s.name].append(s)
    loops = named["device_loop"]
    assert calls and len(loops) == len(calls) == counters["device_loop_calls"]
    assert len(named["chunk_read"]) == counters["device_loop_chunk_reads"] == sum(s.attrs["chunk_reads"] for s in loops)
    assert sum(s.attrs["rounds"] for s in loops) == counters["device_loop_rounds"]
    assert all(n_prop % B == 0 for B, n_prop in calls)
    active = sum(n_prop for _, n_prop in calls) / calls[0][0]
    assert len({B for B, _ in calls}) == 1
    assert counters["device_loop_active_rounds"] == active == sum(s.attrs["active_rounds"] for s in loops)
    assert counters["device_loop_active_rounds"] <= counters["device_loop_rounds"]
    assert counters["likelihood_rows"] == sum(s.attrs["rows"] for s in named["likelihood"]) > 0
    # on the CPU the likelihood records no device time
    assert not any("device_s" in s.attrs for s in named["likelihood"])
    # every host read happens inside the run or its set-up
    roots = [s for s in spans if s.parent is None]
    assert counters["host_reads"] == sum(s.attrs["host_reads"] for s in roots) > 0
    # a read of the epoch's losses in each epoch's validation
    assert all(s.attrs["host_reads"] >= 1 for s in named["validation"])


def test_nesting_survives_an_exception():
    with profiling.tracing() as trace:
        with annotate("outer") as outer:
            with pytest.raises(ValueError):
                with annotate("inner"):
                    raise ValueError
            with annotate("after"):
                pass
        with pytest.raises(KeyError):
            with annotate("raises"):
                with annotate("deep"):
                    raise KeyError
        with annotate("root"):
            pass
    by_name = {s.name: s for s in trace.spans}
    assert [s.name for s in trace.spans] == ["inner", "after", "outer", "deep", "raises", "root"]
    assert by_name["inner"].parent == by_name["after"].parent == outer.id
    assert by_name["deep"].parent == by_name["raises"].id
    assert by_name["raises"].parent is None and by_name["root"].parent is None
    assert profiling._recorder is None


def test_start_and_stop_are_paired_and_open_spans_are_left_out():
    with pytest.raises(RuntimeError, match="not on"):
        profiling.stop_tracing()
    profiling.start_tracing()
    try:
        with pytest.raises(RuntimeError, match="already on"):
            profiling.start_tracing()
        left_open = annotate("open", rows=2)
        left_open.__enter__()
        with annotate("child", run=7) as child:
            child.set(pool=3)
    finally:
        trace = profiling.stop_tracing()
    left_open.__exit__(None, None, None)
    (child,) = trace.spans
    assert child.name == "child" and child.run == 7 and child.attrs["pool"] == 3
    assert child.attrs["host_reads"] == 0
    assert set(trace.counters) == set(profiling.populate_counters())
    # the open parent is not in the record: the child's path starts at it
    assert trace.paths() == {child.id: "child"}


def test_a_profiler_sees_the_spans_while_tracing(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("span_under_a_profiler"):
            torch.ones(4).sum()
    assert any(e.name == "span_under_a_profiler" for e in prof.events())


def test_the_program_imports_profiling_without_the_examples():
    code = (
        "import sys\n"
        "import nessai_tpu_torch.flowsampler\n"
        "from nessai_tpu_torch.utils import profiling\n"
        "assert not [m for m in sys.modules if m.startswith('nessai_tpu_torch.examples')]\n"
        "assert profiling.FLAGSHIP_GW_BASIC['nlive'] == 1000 and not profiling.FLAGSHIP_GW_BASIC['plot']\n"
        "from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_MIXTURE_RUN\n"
        "assert FLAGSHIP_INS_MIXTURE_RUN['redraw_samples']\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    with pytest.raises(AttributeError):
        profiling.NOT_A_FLAGSHIP


def test_the_profiling_script_runs_as_a_module_and_asks_for_a_card():
    out = subprocess.run(
        [sys.executable, "-c", "import torch, runpy; torch.cuda.is_available = lambda: False; "
         "runpy.run_module('nessai_tpu_torch.utils.profiling', run_name='__main__')"],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 1 and "needs a CUDA GPU" in out.stderr


# -- the readings of tools/program_trace.py, on synthetic records --------


def _span(name, id, parent, start, end, **attrs):
    return Span(name, id, parent, 1, int(start * 1e9), int(end * 1e9), attrs)


def _record():
    spans = [
        _span("epoch", 3, 2, 1.0, 2.0, training=2),
        _span("epoch", 4, 2, 2.0, 3.0, training=2),
        _span("training", 2, 1, 1.0, 3.0, training=2, host_reads=5),
        _span("likelihood", 7, 6, 4.0, 4.5, rows=100, device_s=0.002, pool=5),
        _span("likelihood", 8, 6, 4.5, 4.6, rows=300, device_s=0.002, pool=5),
        _span("likelihood", 9, 6, 4.6, 4.7, rows=1000, pool=5),
        _span("chunk_read", 10, 6, 4.7, 4.9, pool=5),
        _span("device_loop", 6, 5, 4.0, 5.0, pool=5),
        _span("populate", 5, 1, 3.5, 5.5, pool=5),
        _span("run", 1, None, 0.0, 6.0),
    ]
    return Trace(spans, dict(device_loop_rounds=40, device_loop_active_rounds=30))


def test_program_trace_readings_on_a_synthetic_record():
    from tools import program_trace as pt

    trace = _record()
    assert pt.likelihood_us_row(trace) == pytest.approx(1e6 * 0.004 / 400)
    assert pt.masked_round_share(trace) == pytest.approx(25.0)
    assert pt.host_reads_epoch(trace) == pytest.approx(2.5)
    kernels = [(1.5, 1.75), (1.6, 1.8), (2.9, 3.2), (4.2, 4.3), (6.5, 7.0)]
    merged = pt.merge(kernels)
    assert merged == ([1.5, 2.9, 4.2, 6.5], [1.8, 3.2, 4.3, 7.0])
    assert pt.busy_share(trace, "epoch", merged) == pytest.approx(100 * 0.4 / 2.0)
    assert pt.busy_share(trace, "device_loop", merged) == pytest.approx(10.0)
    assert pt.busy_share(trace, "checkpoint", merged) is None
    gaps = [(1.8, 2.9), (4.75, 4.8), (5.6, 5.9), (6.1, 6.5)]
    assert pt.label_gaps(trace, gaps, top=3) == [
        ["run/training/epoch", pytest.approx(1.1)],
        ["none", pytest.approx(0.4)],
        ["run", pytest.approx(0.3)],
    ]
    assert pt.split_gaps(trace, [(0.5, 1.5), (4.75, 4.8)], top=1) == [
        [1.0, [["run", pytest.approx(0.5)], ["run/training/epoch", pytest.approx(0.5)]]]
    ]
    assert pt.split_gaps(trace, [(3.0, 4.2), (5.9, 6.5)], parts=2) == [
        [pytest.approx(1.2), [["run", pytest.approx(0.5)], ["run/populate", pytest.approx(0.5)]]],
        [pytest.approx(0.6), [["none", pytest.approx(0.5)], ["run", pytest.approx(0.1)]]],
    ]
    (split,) = pt.split_gaps(trace, [(3.0, 4.2)], parts=4)
    assert split[1][2] == ["run/populate/device_loop/likelihood", pytest.approx(0.2)]
    read = pt.readings(trace, kernels, (0.0, 7.0))
    assert read["idle_gaps"][:2] == [["run/populate", pytest.approx(2.2)], ["run", pytest.approx(1.5)]]
    assert read["spans"]["run/populate/device_loop/likelihood"] == 3
    assert read["seconds"]["run/training"] == pytest.approx(2.0)


def test_program_trace_moves_the_kernels_by_the_markers_launch():
    from tools import program_trace as pt

    kernels = [("k", 0.2, 0.6), ("k", 0.1, 0.3), ("k", 4.4, 4.8), ("k", 5.0, 6.0)]
    win = types.SimpleNamespace(marker_launch=0.5, t0=1.0, t_close=5.0, trace=types.SimpleNamespace(kernels=kernels))
    assert pt.device_intervals(win) == [(1.0, pytest.approx(1.1)), (pytest.approx(4.9), 5.0)]
    win.marker_launch = 0.0
    assert pt.device_intervals(win) == [(4.4, 4.8)]


def test_program_trace_readings_of_an_empty_record():
    from tools import program_trace as pt

    read = pt.readings(Trace([], {}))
    assert read["likelihood_us_row"] is None and read["masked_round_share"] is None
    assert read["host_reads_epoch"] is None and read["train_busy_share"] is None
    assert read["idle_gaps"] is None and read["spans"] == {}


def test_program_trace_records_a_harness_window_on_the_cpu():
    """``tools/program_trace.py``'s recorder around a short window of a
    small ``gw_basic.ns`` on the CPU: the window's spans and counters are
    read, the harness is restored after."""
    from portbench import harness
    from portbench.ns import Recorder
    from tools import program_trace as pt

    small = dict(
        sampler_kwargs=dict(
            harness.load_config("gw_basic")["sampler_kwargs"], nlive=100, flow_config=dict(n_blocks=2, n_neurons=8)
        )
    )
    start, window = Recorder.start, harness.Window
    with pt.recording() as windows:
        result = harness.run_cell("gw_basic.ns", 2**31 + 5, 6.0, False, device="cpu", config_override=small)
    assert (Recorder.start, harness.Window) == (start, window) and profiling._recorder is None
    assert windows[0].marker_launch == 0.0
    assert result["correct"], result["checks"]
    (win,) = windows
    read = pt.readings(win.program)
    assert read["spans"]["run"] >= 1 and read["spans"]["setup"] >= 1
    assert read["host_reads_epoch"] >= 1.0
    assert 0.0 <= read["masked_round_share"] < 100.0
    # the spans lie inside the window
    assert all(win.t0 <= s.start * 1e-9 and s.end * 1e-9 <= win.t_close for s in win.program.spans)
