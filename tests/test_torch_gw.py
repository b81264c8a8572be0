"""The port's GW examples (``nessai_tpu_torch/examples/gw/``) against the
JAX scripts (``examples/gw/``): the injected data bit for bit, each
model's ``torch_log_likelihood`` on the CPU against ``jax_log_likelihood``
and the float64 numpy likelihood at 64 prior draws (rtol 1e-4, the JAX
package's own tolerance, ``tests/test_gw_example.py:60-64``), the
calibration's interpolation against ``np.interp``, and capped runs of the
basic, callback and INS examples in both packages with the JAX tests'
settings (the toy, full and calibration runs are in
``tests/test_torch_gw_runs.py``)."""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nessai_tpu_torch import config

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES_GW = os.path.join(ROOT, "examples", "gw")

#: port module -> (model class, arrays that must be the same bits)
MODULES = {
    "basic_gw_example": ("BasicGWModel", ("freqs", "PSD", "DATA")),
    "callback_gw_example": ("LalStyleGWModel", ()),
    "toy_cbc": ("ToyCBCModel", ("t_grid", "data")),
    "full_gw_example": ("FullGWModel", ("freqs", "PSD", "DATA_RE", "DATA_IM", "DET_AMP", "DET_RA_OFF", "DET_DT")),
    "calibration_example": ("CalibratedGWModel", ("freqs", "PSD", "NODE_FREQS", "DATA_RE", "DATA_IM")),
}
#: the port's likelihood data -> the JAX script's float32 array of it
JAX_DATA = {"freqs": "_freqs_j", "data_re": "_data_re_j", "data_im": "_data_im_j", "inv_psd": "_inv_psd_j"}
DEVICE_MODELS = ["basic_gw_example", "toy_cbc", "full_gw_example", "calibration_example"]


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(autouse=True)
def _plain_live_points():
    """The live points' fields without the extra ones an importance nested
    sampler run registers, in both packages; restored after."""
    from nessai_tpu import config as jax_config

    for c in (config, jax_config):
        c.livepoints.reset()
    yield
    for c in (config, jax_config):
        c.livepoints.reset()


def load_jax(name, tmp_path, monkeypatch):
    """The JAX script, as ``tests/test_examples_smoke.py:_load`` loads it
    (its directory on the path for the scripts that import each other)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(EXAMPLES_GW)
    spec = importlib.util.spec_from_file_location(f"gw_{name}", os.path.join(EXAMPLES_GW, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_port(name):
    return importlib.import_module(f"nessai_tpu_torch.examples.gw.{name}")


@pytest.mark.parametrize("name", sorted(MODULES))
def test_the_injection_is_the_same_bits(name, tmp_path, monkeypatch):
    jax_module, port = load_jax(name, tmp_path, monkeypatch), load_port(name)
    for array in MODULES[name][1]:
        a, b = np.asarray(getattr(port, array)), np.asarray(getattr(jax_module, array))
        assert a.dtype == b.dtype and a.shape == b.shape, array
        assert a.tobytes() == b.tobytes(), array
    for key, jax_name in JAX_DATA.items():
        if hasattr(jax_module, jax_name):
            assert port.LIKELIHOOD_DATA[key].tobytes() == np.asarray(getattr(jax_module, jax_name)).tobytes(), key
    ours, theirs = getattr(port, MODULES[name][0])(), getattr(jax_module, MODULES[name][0])()
    assert ours.names == theirs.names
    for n in ours.names:
        np.testing.assert_array_equal(ours.bounds[n], theirs.bounds[n])
    assert os.listdir(tmp_path) == []


def test_the_port_modules_write_nothing_and_import_no_script(tmp_path):
    """Importing every GW module of the port, in a fresh process in an
    empty directory, writes nothing and imports no JAX, no ``nessai_tpu``
    and no script of ``examples/``."""
    names = list(MODULES) + ["ins_gw_example"]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module('nessai_tpu_torch.examples.gw.' + name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'nessai_tpu', *{names!r}))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout == "ok\n", out.stderr
    assert os.listdir(tmp_path) == []


def _draws(model, n=64, seed=12):
    model.set_rng(np.random.default_rng(seed))
    return model.new_point(n)


@pytest.mark.parametrize("name", DEVICE_MODELS)
def test_the_device_likelihood_matches_jax_and_numpy(name, tmp_path, monkeypatch):
    import jax.numpy as jnp

    jax_module, port = load_jax(name, tmp_path, monkeypatch), load_port(name)
    ours, theirs = getattr(port, MODULES[name][0])(), getattr(jax_module, MODULES[name][0])()
    ours.device = "cpu"
    x = _draws(ours)
    assert ours.has_torch_likelihood and ours.torch_likelihood_data is not None
    device = ours.batch_evaluate_log_likelihood(x)
    host = ours.log_likelihood(x)
    np.testing.assert_array_equal(host, theirs.log_likelihood(x))
    np.testing.assert_allclose(device, host, rtol=1e-4)
    arr = jnp.asarray(np.stack([x[n] for n in ours.names], axis=1), jnp.float32)
    if theirs.jax_likelihood_data is not None:
        fn, data = theirs.device_log_likelihood_fn()
        reference = np.asarray(fn(arr, data))
    else:
        reference = np.asarray(theirs.jax_log_likelihood(arr))
    np.testing.assert_allclose(device, reference, rtol=1e-4)
    assert np.all(np.isfinite(device)) and device.shape == (64,)


def test_the_callback_model_is_the_jax_one(tmp_path, monkeypatch):
    jax_module, port = load_jax("callback_gw_example", tmp_path, monkeypatch), load_port("callback_gw_example")
    ours, theirs = port.LalStyleGWModel(), jax_module.LalStyleGWModel()
    x = _draws(ours)
    np.testing.assert_array_equal(ours.log_likelihood(x), theirs.log_likelihood(x))
    np.testing.assert_array_equal(ours.log_prior(x), theirs.log_prior(x))
    assert ours.likelihood_callback and theirs.likelihood_callback
    assert not ours.has_torch_likelihood and ours.allow_vectorised
    theirs.set_rng(np.random.default_rng(0))
    arr = np.stack([x[n] for n in ours.names], axis=1).astype(np.float32)
    fn, data = ours.device_log_likelihood_fn("cpu")
    np.testing.assert_array_equal(fn(torch.as_tensor(arr), data).numpy(), theirs._callback_log_likelihood(arr))
    basic = load_port("basic_gw_example").BasicGWModel()
    np.testing.assert_allclose(fn(torch.as_tensor(arr), data).numpy(), basic.log_likelihood(x), rtol=1e-6)


def test_the_calibration_prior_is_not_a_box_and_matches_jax(tmp_path, monkeypatch):
    jax_module, port = load_jax("calibration_example", tmp_path, monkeypatch), load_port("calibration_example")
    ours, theirs = port.CalibratedGWModel(), jax_module.CalibratedGWModel()
    x = _draws(ours)
    np.testing.assert_array_equal(ours.log_prior(x), theirs.log_prior(x))
    assert not ours.has_uniform_box_prior and not theirs.has_uniform_box_prior


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interp_matches_numpy(seed):
    """Inside, at and outside the nodes (clamped to the end values)."""
    port = load_port("calibration_example")
    rng = np.random.default_rng(seed)
    nodes = np.sort(rng.uniform(0.0, 3.0, 3 + seed))
    x = np.concatenate([rng.uniform(-1.0, 4.0, 200), nodes, [nodes[0] - 1e-3, nodes[-1] + 1e-3]])
    fp = rng.normal(size=(7, nodes.size))
    out = port.interp(torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(nodes), torch.as_tensor(fp)).numpy()
    expected = np.stack([np.interp(x, nodes, row) for row in fp])
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-12)
    out32 = port.interp(
        torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(nodes, dtype=torch.float32),
        torch.as_tensor(fp, dtype=torch.float32),
    ).numpy()
    np.testing.assert_allclose(out32, expected, rtol=0, atol=1e-6)


def test_interp_on_the_example_band_matches_numpy():
    port = load_port("calibration_example")
    data = port.LIKELIHOOD_DATA
    logf = torch.log(torch.as_tensor(data["freqs"]))
    nodes = np.random.default_rng(3).normal(scale=port.CAL_SIGMA, size=(64, port.N_NODES)).astype(np.float32)
    out = port.interp(logf, torch.as_tensor(data["log_nodes"]), torch.as_tensor(nodes)).numpy()
    expected = np.stack([np.interp(np.log(port.freqs), np.log(port.NODE_FREQS), row) for row in nodes])
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# capped runs in both packages, with the JAX tests' settings
# ---------------------------------------------------------------------------
SMALL = dict(
    flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1),
    training_config=dict(max_epochs=10, batch_size=128, patience=5),
    resume=False,
    plot=False,
)


def run_both(name, tmp_path, monkeypatch, run_kwargs=None, **kwargs):
    """The JAX script's model through the JAX package and the port's
    model through the port (on the CPU), with the same arguments."""
    from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
    from nessai_tpu_torch.flowsampler import FlowSampler

    jax_module, port = load_jax(name, tmp_path, monkeypatch), load_port(name)
    cls = MODULES[name][0]
    runs = {}
    for package, make, module in (("jax", JaxFlowSampler, jax_module), ("torch", FlowSampler, port)):
        extra = {"device": "cpu"} if package == "torch" else {}
        model = getattr(module, cls)()
        fs = make(model, output=str(tmp_path / package), **kwargs, **extra)
        fs.run(plot=False, save=False, **(run_kwargs or {}))
        assert np.isfinite(fs.logZ), package
        runs[package] = (fs, model)
    return runs


def _prime(fs):
    return list(fs.ns._flow_proposal.prime_parameters)


def test_basic_gw_example_capped(tmp_path, monkeypatch):
    runs = run_both(
        "basic_gw_example",
        tmp_path,
        monkeypatch,
        nlive=200,
        seed=3,
        max_iteration=250,
        maximum_uninformed=100,
        poolsize=200,
        reparameterisations={"phase": {"reparameterisation": "angle-2pi"}},
        **SMALL,
    )
    assert _prime(runs["torch"][0]) == _prime(runs["jax"][0])
    assert "phase_x" in _prime(runs["torch"][0])
    assert runs["torch"][1].has_torch_likelihood and runs["jax"][1].has_jax_likelihood


def test_callback_gw_example_capped(tmp_path, monkeypatch):
    runs = run_both(
        "callback_gw_example",
        tmp_path,
        monkeypatch,
        nlive=150,
        seed=4,
        max_iteration=200,
        maximum_uninformed=80,
        poolsize=150,
        **SMALL,
    )
    (fs, model), (jfs, jmodel) = runs["torch"], runs["jax"]
    assert not model.has_torch_likelihood and model.likelihood_callback
    assert not jmodel.has_jax_likelihood and jmodel.likelihood_callback
    assert fs.ns._flow_proposal._can_fuse_populate and jfs.ns._flow_proposal._can_fuse_populate
    assert _prime(fs) == _prime(jfs)


def test_ins_gw_example_capped(tmp_path, monkeypatch):
    runs = run_both(
        "basic_gw_example",
        tmp_path,
        monkeypatch,
        nlive=300,
        seed=5,
        importance_nested_sampler=True,
        max_iteration=3,
        min_samples=100,
        **SMALL,
    )
    for fs, _ in runs.values():
        assert fs.ns.iteration == 3
