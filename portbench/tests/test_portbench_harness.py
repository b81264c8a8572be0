"""The harness's files found by name, its metric arithmetic and its
modules' imports, on the CPU."""

import glob
import json
import os
import subprocess
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import harness, yardstick  # noqa: E402
from portbench.ns import Recorder, sampler_seed  # noqa: E402
from portbench.trace import idle_gaps, label_gaps, union_seconds  # noqa: E402

SPEC = harness.load_spec(ROOT)


# -- files found by name -------------------------------------------------
@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    config = harness.load_config(cell["config"])
    assert config["name"] == cell["config"]
    ref = harness.load_reference(cell["config"])
    assert callable(ref.log_likelihood) and callable(ref.injection)
    traffic = harness.load_traffic(cell["traffic"])
    limits = harness.load_limits(cell["name"])
    from portbench.check import NUMBERS

    assert traffic["sampler"] == "standard"
    assert tuple(limits) == NUMBERS
    for trace in (False, True):
        for m in harness.cell_metrics(SPEC, cell["name"], trace):
            reader = harness.load_metric(m["name"])
            assert reader.UNIT == m["unit"]
            assert callable(reader.read)


def test_every_metric_and_config_file_is_listed():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {os.path.basename(p)[: -len(".py")] for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))}
    assert files == names
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_cell_metrics_split_end_to_end_and_per_layer():
    e2e = harness.cell_metrics(SPEC, "gw_basic.ns", False)
    assert {m["name"] for m in e2e} >= {"iters_per_s", "setup_s"}
    per_layer = harness.cell_metrics(SPEC, "gw_basic.ns", True)
    assert per_layer and all(m["moves"] in {x["name"] for x in e2e} for m in per_layer)


def test_a_new_metric_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "answer.x.py").write_text("UNIT = 'n'\n\ndef read(window):\n    return 42\n")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    assert harness.load_metric("answer.x").read(None) == 42


def test_seeds_of_runs_differ_and_repeat():
    big = 2**31 + 12345
    a = [sampler_seed(big, i) for i in range(4)]
    assert len(set(a)) == 4 and a == [sampler_seed(big, i) for i in range(4)]


# -- metric arithmetic ------------------------------------------------------
def test_union_and_idle_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union_seconds(iv) == pytest.approx(3.0)
    gaps = idle_gaps(iv, -1.0, 5.0)
    assert gaps == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    labels = label_gaps(gaps, [("training", 1.9, 3.2), ("populate", 4.2, 4.8)], top=2)
    assert [x[0] for x in labels] == ["host loop", "training"] or [x[0] for x in labels] == ["training", "host loop"]
    assert all(x[1] == pytest.approx(1.0) for x in labels)


def test_k1_and_scan_counts_match_the_kernel_table():
    # PERF.md's kernel table: 25,200 B at [900, D = 2, n_tr = 1], forward;
    # 104,000 B at [2000, 4, 2]; 32,400 B backward at [900, 2, 1]
    assert yardstick.k1_cost(900, 2, 1)[0] == 25_200
    assert yardstick.k1_cost(2000, 4, 2)[0] == 104_000
    assert yardstick.k1_cost(900, 2, 1, backward=True)[0] == 32_400
    assert yardstick.least_seconds(*yardstick.k1_cost(900, 2, 1)) * 1e6 == pytest.approx(0.0075, abs=1e-4)
    n_bytes, n_ops = yardstick.scan_cost(1000, 1024, 0)
    assert n_bytes == 4 * 1000 + 4 * 1024 + 1024 + 8 * 1024 + 4 * 1000 + 4
    assert n_ops == 1024 * (10 + 2)


def test_flow_flops():
    # 5 -> 10 input layer, two blocks of 10 x 10 twice, 10 -> 4 output
    assert yardstick.resnet_flops_per_row(3, 4, 10, 2) == 2 * (30 + 2 * 2 * 100 + 40)
    f = yardstick.coupling_flops_per_row(3, 2, 10, 2)
    assert yardstick.coupling_flops_per_row(3, 2, 10, 2, backward=True) == 3 * f


def _window(commits, seconds=10.0, spans=()):
    rec = Recorder(seconds)
    rec.t0 = 100.0
    rec.commits = list(commits)
    rec.spans = list(spans)
    w = harness.Window(rec, None, {"likelihood_flops_per_row": 10}, 3.5, 112.0)
    return w


def test_window_rate_counts_what_was_committed_by_the_end():
    w = _window([(101.0, 100, 400), (109.9, 900, 3600), (111.5, 1300, 5200)])
    assert w.iterations == 900 and w.evaluations == 3600
    assert harness.load_metric("iters_per_s").read(w) == pytest.approx(90.0)
    assert harness.load_metric("evals_per_iter").read(w) == pytest.approx(4.0)
    assert harness.load_metric("setup_s").read(w) == 3.5
    assert w.traced_evaluations == 5200


def test_shares_and_epochs_from_spans():
    spans = [
        ("training", 99.0, 101.0, 10),
        ("training", 102.0, 104.0, 40),
        ("populate", 104.0, 105.0, 0),
        ("commit", 105.0, 106.0, 0),
        ("training", 109.0, 111.0, 40),
    ]
    w = _window([(110.0, 10, 10)], spans=spans)
    # inside the window: training 1 + 2 + 1 s, populate 1 s
    assert harness.load_metric("host_share.ns").read(w) == pytest.approx(50.0)
    assert harness.load_metric("populate_share.ns").read(w) == pytest.approx(10.0)
    # only the training that ended inside the window: 2 s over 40 epochs
    assert harness.load_metric("epoch_ms.ns").read(w) == pytest.approx(50.0)


def test_device_metrics_need_a_trace():
    w = _window([(101.0, 1, 1)])
    for name in ("k1_roofline.ns", "scan_roofline.ns", "mfu.ns", "idle_share.ns"):
        assert harness.load_metric(name).read(w) is None


def test_roofline_and_idle_from_a_trace():
    w = _window([(101.0, 1, 1)])
    w.rec.k1 = {(1000, 12, 6, False, True): 10, (8192, 12, 6, True, False): 5}
    trace = types.SimpleNamespace()
    kernels = [("affine_coupling_kernel", 100.0 + i * 1e-3, 100.0 + i * 1e-3 + 2e-6) for i in range(15)]
    kernels += [("affine_coupling_backward_kernel", 101.0 + i * 1e-3, 101.0 + i * 1e-3 + 2e-6) for i in range(10)]
    trace.seconds_by_name = lambda s, e: {
        "affine_coupling_kernel": 15 * 2e-6,
        "affine_coupling_backward_kernel": 10 * 2e-6,
    }
    trace.clipped = lambda s, e: [(a, b) for _, a, b in kernels]
    w.trace = trace
    bound = 10 * yardstick.least_seconds(*yardstick.k1_cost(1000, 12, 6))
    bound += 10 * yardstick.least_seconds(*yardstick.k1_cost(1000, 12, 6, backward=True))
    bound += 5 * yardstick.least_seconds(*yardstick.k1_cost(8192, 12, 6, inverse=True))
    assert harness.load_metric("k1_roofline.ns").read(w) == pytest.approx(100 * bound / 50e-6)
    assert harness.load_metric("idle_share.ns").read(w) == pytest.approx(100 * (1 - 50e-6 / 12.0))
    w.flow_widths = (32, 2)
    flops = 10 * 1000 * yardstick.coupling_flops_per_row(6, 6, 32, 2, backward=True)
    flops += 5 * 8192 * yardstick.coupling_flops_per_row(6, 6, 32, 2) + 1 * 10
    assert harness.load_metric("mfu.ns").read(w) == pytest.approx(100 * flops / (12.0 * 67e12))


# -- imports ------------------------------------------------------------------
def test_no_harness_module_loads_jax_or_the_jax_package():
    """Import every module of the harness in a fresh interpreter and look
    at the top-level names of what is loaded."""
    code = f"""
import glob, importlib, importlib.util, os, sys
sys.path.insert(0, {ROOT!r})
bench = {BENCH!r}
for path in sorted(glob.glob(os.path.join(bench, "*.py")) + glob.glob(os.path.join(bench, "reference", "*.py"))):
    rel = os.path.relpath(path, {ROOT!r})[:-3].replace(os.sep, ".")
    importlib.import_module(rel.removesuffix(".__init__"))
for path in sorted(glob.glob(os.path.join(bench, "metrics", "*.py")) + glob.glob(os.path.join(bench, "configs", "*.py"))):
    spec = importlib.util.spec_from_file_location("m_" + os.path.basename(path).replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import portbench.ns, portbench.check
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"'))
    for name in harness.FORBIDDEN:
        assert name not in loaded, name


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nessai_tpu_torch_fake", types.ModuleType("nessai_tpu_torch_fake"))
    assert "nessai_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib.fake" in harness.forbidden_modules()


def test_the_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "gw_basic.ns", "--seed", "1", "--seconds", "1"],
        capture_output=True,
        text=True,
        cwd=ROOT,
        timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
