"""Result files of the port against the JAX package's: the result
dictionaries' keys, the JSON encoder, JSON and HDF5 result files, the
``.old`` rotation of ``safe_file_dump``, ``config.json`` and the
multi-seed evidence."""

import copy
import json
import os
import pickle

import h5py
import numpy as np
import pytest

import nessai_tpu.utils.multirun as jax_multirun
from nessai_tpu import config as jax_config
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.utils import io as jax_io
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
import nessai_tpu_torch.utils.multirun as multirun
from nessai_tpu_torch import config
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.utils import io
from nessai_tpu_torch.utils.testing import IntegrationTestModel

FLOW = dict(n_blocks=2, n_neurons=4, n_layers=1)
RUNS = {
    "standard": dict(nlive=50, seed=3, flow_config=FLOW, training_config=dict(max_epochs=5, patience=3)),
    "ins": dict(importance_nested_sampler=True, nlive=100, min_samples=50, seed=3, max_iteration=2,
                flow_config=FLOW, training_config=dict(max_epochs=5, patience=3, batch_size=100)),
}


def _run(package, output, sampler, **kwargs):
    common = dict(output=output, resume=False, plot=False, checkpointing=False, signal_handling=False)
    if package == "torch":
        fs = FlowSampler(IntegrationTestModel(2), device="cpu", **common, **RUNS[sampler], **kwargs)
    else:
        fs = JaxFlowSampler(JaxModel(2), **common, **RUNS[sampler], **kwargs)
    fs.run(plot=False, save=False)
    return fs


@pytest.fixture(scope="module", params=["standard", "ins"])
def runs(request, tmp_path_factory):
    """Both packages' runs of one sampler on the same seed.

    The extra live-point fields (the importance nested sampler's logW,
    logQ and logU) are global in each package, and an importance nested
    sampler run earlier in the process leaves them registered: the
    standard runs then write them in one package and not in the other.
    Both packages start these runs without them, and get back what they
    held before."""
    saved = [copy.deepcopy(c.livepoints.__dict__) for c in (config, jax_config)]
    for c in (config, jax_config):
        c.livepoints.reset()
    try:
        out = {p: _run(p, str(tmp_path_factory.mktemp(p)), request.param) for p in ("torch", "jax")}
    finally:
        for c, state in zip((config, jax_config), saved):
            c.livepoints.__dict__.update(state)
            if hasattr(c.livepoints, "reset_properties"):
                c.livepoints.reset_properties()
    return request.param, out


def test_result_dictionary_keys(runs):
    _, fs = runs
    assert set(fs["torch"].ns.get_result_dictionary()) == set(fs["jax"].ns.get_result_dictionary())
    assert set(fs["torch"].result) == set(fs["jax"].result)


def _hdf5_layout(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, (obj.dtype.str, obj.ndim) if isinstance(obj, h5py.Dataset) else "group"))
    return out


def _hdf5_values(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("extension", ["json", "hdf5"])
def test_result_files_match_the_jax_packages(runs, extension, tmp_path):
    """The runs' result files have the JAX package's keys and, field by
    field, its dtypes and ranks; the port's result dictionary written by
    both packages' ``save_results`` gives the same file."""
    sampler, fs = runs
    paths = {}
    for package, f in fs.items():
        paths[package] = str(tmp_path / f"{package}.{extension}")
        f.save_results(paths[package])
    # the port's result through the JAX package's writer
    jfs = fs["jax"]
    saved, jfs._result = jfs._result, dict(fs["torch"].result)
    try:
        jfs.save_results(str(tmp_path / f"same.{extension}"))
    finally:
        jfs._result = saved
    if extension == "json":
        loaded = {p: json.load(open(path)) for p, path in paths.items()}
        assert set(loaded["torch"]) == set(loaded["jax"])
        for key in ("nested_samples", "posterior_samples"):
            assert set(loaded["torch"][key]) == set(loaded["jax"][key])
        assert set(loaded["torch"]["history"]) == set(loaded["jax"]["history"])
        with open(paths["torch"]) as a, open(tmp_path / "same.json") as b:
            assert a.read() == b.read()
    else:
        assert _hdf5_layout(paths["torch"]) == _hdf5_layout(paths["jax"])
        ours, same = _hdf5_values(paths["torch"]), _hdf5_values(str(tmp_path / "same.hdf5"))
        assert set(ours) == set(same)
        for key, value in ours.items():
            assert np.asarray(value).tobytes() == np.asarray(same[key]).tobytes(), key


def test_json_encoder_matches_the_jax_packages(tmp_path):
    """Structured arrays, NaN and infinities, numpy scalars, nested
    dicts, None, callables and classes: the same text in both."""
    structured = np.zeros(3, dtype=[("x", "f8"), ("it", "i4")])
    structured["x"] = [np.nan, np.inf, -1.5]
    d = dict(
        structured=structured,
        floats=np.array([np.nan, np.inf, -np.inf, 0.1]),
        scalars=[np.float32(0.5), np.int64(3), np.float64(np.nan), np.bool_(True)],
        nested={"a": np.arange(3), "b": None, "c": {"d": np.float64(2.0)}},
        function=np.mean,
        cls=dict,
        obj=object.__new__(type("Thing", (), {"__repr__": lambda self: "Thing()"})),
    )
    io.save_to_json(d, tmp_path / "torch.json")
    jax_io.save_to_json(d, tmp_path / "jax.json")
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    for x in (1, "a", [1, 2], {"a": 1}, np.float64(1.0), object(), np.zeros(2)):
        assert io.is_jsonable(x) == jax_io.is_jsonable(x)


@pytest.mark.parametrize("save_existing", [True, False])
def test_safe_file_dump_rotates_to_old(tmp_path, save_existing):
    for package, module in (("torch", io), ("jax", jax_io)):
        path = tmp_path / f"{package}.pkl"
        module.safe_file_dump({"n": 1}, path, save_existing=save_existing)
        module.safe_file_dump({"n": 2}, path, save_existing=save_existing)
        assert pickle.loads(path.read_bytes()) == {"n": 2}
        old = tmp_path / f"{package}.pkl.old"
        assert old.exists() == save_existing
        if save_existing:
            assert pickle.loads(old.read_bytes()) == {"n": 1}
        assert not (tmp_path / f"{package}.pkl.temp").exists()


def test_config_json_matches_the_jax_packages(tmp_path):
    kwargs = dict(nlive=50, seed=3, flow_config=FLOW, training_config=dict(max_epochs=5), poolsize=50, plot=False,
                  checkpointing=False)
    FlowSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), device="cpu", resume=False,
                signal_handling=False, **kwargs)
    JaxFlowSampler(JaxModel(2), output=str(tmp_path / "jax"), resume=False, signal_handling=False, **kwargs)
    ours = json.loads((tmp_path / "torch" / "config.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "config.json").read_text())
    expected = {k: v for k, v in kwargs.items() if k != "seed"}
    assert ours == theirs == dict(expected, importance_nested_sampler=False)


@pytest.mark.parametrize("errors", [None, [0.1, 0.2, 0.15, 0.05]])
def test_combine_log_evidence(errors):
    lz = [-6.01, -5.97, -6.05, -5.99]
    ours = multirun.combine_log_evidence(lz, errors)
    theirs = jax_multirun.combine_log_evidence(lz, errors)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        multirun.combine_log_evidence([1.0])


def test_multi_seed_evidence(monkeypatch, tmp_path):
    """The same per-run seeds, outputs and arguments as the JAX package,
    and the same combination of the runs' evidences (a stand-in sampler
    gives each seed's logZ)."""
    calls = {}

    def fake(package):
        class Fake:
            def __init__(self, model, output, seed, **kwargs):
                calls.setdefault(package, []).append((os.path.basename(output), seed, sorted(kwargs)))
                self.logZ = -6.0 + (seed % 1000) / 1e4
                self.log_evidence_error = 0.05 + (seed % 7) / 1e3

            def run(self, **kwargs):
                return self.logZ, None

        return Fake

    import nessai_tpu.flowsampler as jax_flowsampler
    import nessai_tpu_torch.flowsampler as flowsampler

    monkeypatch.setattr(flowsampler, "FlowSampler", fake("torch"))
    monkeypatch.setattr(jax_flowsampler, "FlowSampler", fake("jax"))
    ours = multirun.multi_seed_evidence(lambda: IntegrationTestModel(2), n_runs=3, seed=7,
                                        output=str(tmp_path / "t"), nlive=50)
    theirs = jax_multirun.multi_seed_evidence(lambda: JaxModel(2), n_runs=3, seed=7, output=str(tmp_path / "j"),
                                              nlive=50)
    assert calls["torch"] == calls["jax"]
    assert ours["runs"] == theirs["runs"]
    for k in ("log_evidence", "log_evidence_error", "seed_scatter_std", "propagated_error"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-12)
