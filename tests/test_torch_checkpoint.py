"""Checkpoint and resume of both samplers in the port against the JAX
package: the state a resume restores bit for bit, the state both drop on
purpose, the ``.old`` fallback, ``resume_data``, a moved output, the
likelihood counters, the INS log_q recomputed through the reloaded
levels (and through the JAX package's level files), a resumed run's
evidence, what a checkpoint may hold, the reference's defaults and the
device rule."""

import copy
import ctypes
import inspect
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.samplers.importancesampler import ImportanceNestedSampler as JaxINS
from nessai_tpu.samplers.nestedsampler import NestedSampler as JaxNestedSampler
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.flowmodel import FlowModel
from nessai_tpu_torch.flows.convert import level_state_dicts_from_jax, state_dict_from_jax_file
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.proposal import ImportanceFlowProposal
from nessai_tpu_torch.samplers import ImportanceNestedSampler, NestedSampler
from nessai_tpu_torch.utils.testing import IntegrationTestModel, pickled_types, time_limit

FLOW = dict(n_blocks=2, n_neurons=8, n_layers=1)
TRAIN = dict(max_epochs=20, patience=5, batch_size=200)
#: a standard run of both packages that trains a few times
STANDARD = dict(nlive=200, seed=11, flow_config=FLOW, training_config=TRAIN, plot=False)
#: a capped INS run of both packages
INS = dict(
    importance_nested_sampler=True,
    nlive=200,
    min_samples=100,
    seed=8,
    flow_config=FLOW,
    training_config=TRAIN,
    plot=False,
)
NS_STATE = ("logZ", "oldZ", "logw", "info", "logLs", "log_vols", "nlives")
INS_STATE = ("_weights_nested", "_weights_live", "_previous_logZ")
#: attributes of the port's pickles that the JAX package's do not have:
#: the device, the batched consume's carried count, the sample stores'
#: log_q timer and the kernels' generators of the INS levels
PORT_ONLY = {"device", "_count_carry", "update_log_q_time", "_logged_host_inverse", "_truncation", "reparameterisation"}


def _fs(package, model=None, **kwargs):
    if package == "torch":
        return FlowSampler(model or IntegrationTestModel(2), device="cpu", signal_handling=False, **kwargs)
    return JaxFlowSampler(model or JaxModel(2), signal_handling=False, **kwargs)


def _snapshot(ns):
    """The state a resume must restore, copied."""
    out = dict(iteration=ns.iteration, rng=copy.deepcopy(ns.rng.bit_generator.state))
    if hasattr(ns, "live_points") and not hasattr(ns, "training_samples"):
        out["live_points"] = ns.live_points.tobytes()
        out["nested_samples"] = np.asarray(ns.nested_samples_array).tobytes()
        out["state"] = {a: np.asarray(getattr(ns.state, a)).tobytes() for a in NS_STATE}
    else:
        out["samples"] = ns.training_samples.samples.tobytes()
        out["log_q"] = ns.training_samples.log_q.copy()
        out["state"] = {a: np.asarray(getattr(ns.training_samples.state, a)).tobytes() for a in INS_STATE}
        out["logZ"] = ns.log_evidence
    return out


def _record_checkpoints(records):
    def callback(sampler):
        records.append((pickle.dumps(sampler), _snapshot(sampler), sampler.finalised))

    return callback


def _compare(ns, snap, flows_built: int):
    """Which parts of ``snap`` the resumed ``ns`` holds bit for bit. The
    host generator is compared after replaying the ``flows_built`` seeds
    that rebuilding the flows draws from it."""
    rng = np.random.default_rng()
    rng.bit_generator.state = copy.deepcopy(snap["rng"])
    for _ in range(flows_built):
        rng.integers(0, 2**31 - 1)
    now = _snapshot(ns)
    out = {k: now[k] == snap[k] for k in snap if k not in ("rng", "log_q", "logZ")}
    out["rng"] = ns.rng.bit_generator.state == rng.bit_generator.state
    return out


# ----------------------------------------------------------------------
# The standard sampler
# ----------------------------------------------------------------------
def _standard_checkpoint(package, output):
    """Run the standard sampler with a checkpoint after every training
    (into a list); write the last one before the end to the resume file.
    Returns the run and that checkpoint's snapshot."""
    records = []
    fs = _fs(package, output=output, resume=False, checkpoint_on_training=True,
             checkpoint_callback=_record_checkpoints(records), **STANDARD)
    with time_limit(300):
        fs.run(plot=False, save=False)
    data, snap, _ = [r for r in records if not r[2]][-1]
    with open(os.path.join(output, "nested_sampler_resume.pkl"), "wb") as f:
        f.write(data)
    return fs, snap, data


@pytest.fixture(scope="module")
def standard_runs(tmp_path_factory):
    """Both packages' standard runs and their last training checkpoint."""
    return {p: (tmp_path_factory.mktemp(p),) + _standard_checkpoint(p, str(tmp_path_factory.mktemp(p + "_run")))
            for p in ("torch", "jax")}


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_standard_resume_restores_the_pickled_state(standard_runs, package, tmp_path):
    """FlowSampler(resume=True) restores the iteration, live points,
    nested samples, evidence state and host generator bit for bit in both
    packages, and the port wherever the JAX package does; the rebuilt
    flow takes the weights file's weights; the likelihood counter carries
    over; the resumed run finishes within 3σ."""
    _, fs, snap, data = standard_runs[package]
    for name in ("nested_sampler_resume.pkl",):
        with open(tmp_path / name, "wb") as f:
            f.write(data)
    pickled = pickle.loads(data)
    weights = pickled._flow_proposal._weights_file
    model = IntegrationTestModel(2) if package == "torch" else JaxModel(2)
    fs2 = _fs(package, model=model, output=str(tmp_path), resume=True, weights_path=weights,
              flow_config=FLOW, training_config=TRAIN)
    outcome = _compare(fs2.ns, snap, flows_built=1)
    assert model.likelihood_evaluations == pickled._previous_likelihood_evaluations
    if package == "torch":
        assert all(outcome.values()), outcome
        saved = torch.load(weights, weights_only=True)
        for k, v in fs2.ns.flow_proposal.flow.flow.state_dict().items():
            assert torch.equal(v, saved[k]), k
        # a run past the switch resumes on the flow proposal
        fs2.ns.initialise()
        assert fs2.ns.proposal is fs2.ns.flow_proposal
    else:
        _, _, jsnap, _ = standard_runs["torch"]
        assert all(outcome.values()), outcome
    with time_limit(300):
        fs2.run(plot=False, save=False)
    pull = (fs2.logZ - model.analytic_log_evidence) / fs2.logZ_error
    assert abs(pull) < 3, pull
    assert fs2.ns.iteration > pickled.iteration


def test_jax_resume_reselects_the_uninformed_proposal(standard_runs, tmp_path):
    """The deliberate difference: after a resume past the switch to the
    flow proposal but before ``maximum_uninformed``, the JAX package's
    ``initialise`` selects the uninformed proposal again; the port keeps
    the flow proposal."""
    outcome = {}
    for package in ("torch", "jax"):
        _, _, _, data = standard_runs[package]
        out = tmp_path / package
        out.mkdir()
        with open(out / "nested_sampler_resume.pkl", "wb") as f:
            f.write(data)
        fs = _fs(package, output=str(out), resume=True, flow_config=FLOW, training_config=TRAIN)
        assert fs.ns.uninformed_sampling is False and fs.ns.proposal is fs.ns._flow_proposal
        fs.ns.initialise()
        outcome[package] = fs.ns.proposal is fs.ns._flow_proposal
    assert outcome == {"torch": True, "jax": False}


@pytest.mark.parametrize("package", ["torch", "jax"])
@pytest.mark.parametrize("corrupt", ["main", "both"])
def test_old_file_fallback_and_fresh_start(standard_runs, package, corrupt, tmp_path):
    """A corrupt resume file falls back to ``<file>.old``; with both
    corrupt the run starts afresh."""
    _, _, snap, data = standard_runs[package]
    main = tmp_path / "nested_sampler_resume.pkl"
    main.write_bytes(b"not a pickle")
    (tmp_path / "nested_sampler_resume.pkl.old").write_bytes(data if corrupt == "main" else b"nor this")
    fs = _fs(package, output=str(tmp_path), resume=True, flow_config=FLOW, training_config=TRAIN, nlive=200,
             seed=11, plot=False)
    if corrupt == "main":
        assert fs.ns.iteration == snap["iteration"] > 0
    else:
        assert fs.ns.iteration == 0 and fs.ns.live_points is None


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_resume_data_and_a_new_output(standard_runs, package, tmp_path):
    """``resume_data`` resumes an unpickled sampler; a sampler resumed
    into another output moves its resume file and proposal output
    there."""
    _, _, snap, data = standard_runs[package]
    fs = _fs(package, output=str(tmp_path / "a"), resume_data=pickle.loads(data), flow_config=FLOW,
             training_config=TRAIN)
    assert fs.ns.iteration == snap["iteration"]
    (tmp_path / "b").mkdir()
    src = tmp_path / "b" / "nested_sampler_resume.pkl"
    src.write_bytes(data)
    sampler = (NestedSampler if package == "torch" else JaxNestedSampler).resume(
        str(src), IntegrationTestModel(2) if package == "torch" else JaxModel(2),
        output=str(tmp_path / "c"), flow_config=FLOW, training_config=TRAIN,
        **({"device": "cpu"} if package == "torch" else {}),
    )
    assert sampler.output == str(tmp_path / "c")
    assert sampler.resume_file == str(tmp_path / "c" / "nested_sampler_resume.pkl")
    assert sampler._flow_proposal.output == os.path.join(str(tmp_path / "c"), "proposal", "")


def test_pickles_carry_and_drop_the_same_state(standard_runs):
    """The port's sampler and flow-proposal pickles carry the JAX
    package's attributes (less those of options the port does not take,
    plus its own), and both drop the pool, the populated flag and the
    flow; the flow model drops its optimiser in both."""
    states = {p: pickle.loads(standard_runs[p][3]) for p in ("torch", "jax")}
    t, j = states["torch"], states["jax"]
    assert set(t.__dict__) - set(j.__dict__) <= PORT_ONLY | {"poolsize"}
    for key in ("iteration", "live_points", "nested_samples", "state", "rng", "history", "insertion_indices",
                "training_iterations", "train_count", "uninformed_sampling", "checkpointing", "resume_file",
                "_previous_likelihood_evaluations", "_previous_likelihood_evaluation_time"):
        assert key in t.__dict__ and key in j.__dict__, key
    for s in (t, j):
        p = s._flow_proposal
        assert p.flow is None and p.samples == [] and p.indices == [] and p.populated is False and p.x is None
        assert p._weights_file is not None and p._reparameterisation is not None
        assert "model" not in s.__dict__ and p.model is None
    assert set(t._flow_proposal.__dict__) - set(j._flow_proposal.__dict__) <= PORT_ONLY | {
        "save_flow_weights", "flow_config"}
    model = FlowModel(dict(n_inputs=2, **FLOW), output=None, device="cpu")
    model.initialise()
    jmodel = JaxFlowModel(dict(n_inputs=2, **FLOW))
    jmodel.initialise()
    assert model.__getstate__()["optimiser"] is None and jmodel.__getstate__()["opt_state"] is None


def _no_device_objects(obj):
    seen = pickled_types(obj)
    assert not [o for o in seen if isinstance(o, torch.nn.Module)]
    assert not [o for o in seen if isinstance(o, torch.Tensor) and o.device.type != "cpu"]
    assert not [o for o in seen if isinstance(o, torch.Generator)]
    assert not [o for o in seen if isinstance(o, (ctypes.CDLL, ctypes._CFuncPtr))]
    return seen


def test_a_checkpoint_holds_no_module_generator_or_library(standard_runs, tmp_path):
    """The sampler pickles (standard, INS, and a flow model on its own)
    hold no ``nn.Module``, no generator object and no ctypes handle;
    the flow model's generators go in as CPU byte tensors."""
    _no_device_objects(pickle.loads(standard_runs["torch"][3]))
    fs = _fs("torch", output=str(tmp_path), resume=False, max_iteration=1, **INS)
    fs.run(plot=False, save=False)
    _no_device_objects(fs.ns)
    flow = fs.ns.proposal.flow
    seen = _no_device_objects(flow)
    assert any(isinstance(o, torch.Tensor) and o.dtype == torch.uint8 for o in seen)
    restored = pickle.loads(pickle.dumps(flow))
    assert torch.equal(restored._sample_generator.get_state(), flow._sample_generator.get_state())
    assert restored.models == [] and restored.flow is not None


# ----------------------------------------------------------------------
# The importance nested sampler
# ----------------------------------------------------------------------
def _ins_checkpoint(package, output, levels=2):
    """The INS to the end of level ``levels``, its checkpoint there (from
    the end-of-level checkpoints, through a callback) written to the
    resume file. Returns the run and the checkpoint's snapshot."""
    records = []
    fs = _fs(package, output=output, resume=False, max_iteration=levels, checkpoint_on_iteration=True,
             checkpoint_interval=1, checkpoint_callback=_record_checkpoints(records), **INS)
    with time_limit(300):
        fs.run(plot=False, save=False)
    data, snap, _ = [r for r in records if not r[2]][-1]
    with open(os.path.join(output, "nested_sampler_resume.pkl"), "wb") as f:
        f.write(data)
    return fs, snap


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_ins_resume_restores_the_state_and_recomputes_log_q(package, tmp_path):
    """The INS checkpoint at the end of a level resumes with its samples
    and evidence state bit for bit and logZ to 1e-8; log_q (not in the
    pickle, ``save_log_q=False``) recomputed through the reloaded levels
    to 1e-5; the run then finishes within 3σ."""
    fs, snap = _ins_checkpoint(package, str(tmp_path))
    model = IntegrationTestModel(2) if package == "torch" else JaxModel(2)
    fs2 = _fs(package, model=model, output=str(tmp_path), resume=True, flow_config=FLOW, training_config=TRAIN,
              importance_nested_sampler=True)
    ns = fs2.ns
    outcome = _compare(ns, snap, flows_built=0)
    outcome.pop("rng")
    assert all(outcome.values()), outcome
    assert abs(ns.log_evidence - snap["logZ"]) <= 1e-8
    np.testing.assert_allclose(ns.training_samples.log_q, snap["log_q"], atol=1e-5, rtol=0)
    ns.configure_iterations(max_iteration=None)
    with time_limit(300):
        fs2.run(plot=False, save=False)
    assert ns.iteration > snap["iteration"]
    pull = (fs2.logZ - model.analytic_log_evidence) / fs2.logZ_error
    assert abs(pull) < 3, pull


def test_ins_log_q_through_the_jax_level_files(tmp_path):
    """The JAX package's ``level_<i>/model.pkl`` files loaded into the
    port (``level_state_dicts_from_jax``) give the JAX package's log_q on
    its samples to 1e-5 of (1 + |log_q|): both are float32 flows, and
    far in a level's tail (log_q near -95, where a float32 ulp is 7.6e-6)
    the two packages' roundings differ by a few ulp."""
    jfs = _fs("jax", output=str(tmp_path), resume=False, max_iteration=2, draw_iid_live=False, **INS)
    jfs.run(plot=False, save=False)
    jns = jfs.ns
    jns.proposal.flow._join_pending_save()
    proposal = ImportanceFlowProposal(IntegrationTestModel(2), output=str(tmp_path / "port"), flow_config=FLOW,
                                      rng=np.random.default_rng(1), device="cpu")
    proposal.flow.initialise()
    levels = level_state_dicts_from_jax(proposal.flow.flow, os.path.join(jns.proposal.output))
    assert len(levels) == 2
    proposal.flow.models = []
    for state in levels:
        proposal.flow.flow.load_state_dict(state)
        proposal.flow.add_level(proposal.flow.flow)
    proposal._weights = dict(jns.proposal.weights)
    x_prime, log_j = proposal.rescale(jns.training_samples.samples)
    _, log_q = proposal.compute_log_Q(x_prime, log_j)
    theirs = jns.training_samples.log_q
    assert log_q.shape == theirs.shape
    assert np.max(np.abs(log_q - theirs) / (1 + np.abs(theirs))) <= 1e-5


def test_flow_weights_file_of_the_jax_package(tmp_path):
    """A JAX ``FlowModel.save_weights`` file read into the port's
    ``state_dict`` gives the JAX flow's log_prob to 1e-5."""
    jmodel = JaxFlowModel(dict(n_inputs=2, **FLOW), output=str(tmp_path))
    jmodel.initialise()
    path = str(tmp_path / "model.pkl")
    jmodel.save_weights(path)
    model = FlowModel(dict(n_inputs=2, **FLOW), output=str(tmp_path), device="cpu")
    model.initialise()
    model.flow.load_state_dict(state_dict_from_jax_file(model.flow, path))
    x = np.random.default_rng(2).normal(size=(500, 2))
    np.testing.assert_allclose(model.log_prob(x), jmodel.log_prob(x), atol=1e-5, rtol=0)


# ----------------------------------------------------------------------
# The reference's defaults and the device rule
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "ours, theirs",
    [
        (FlowSampler.__init__, JaxFlowSampler.__init__),
        (FlowSampler.run, JaxFlowSampler.run),
        (FlowSampler.run_standard_sampler, JaxFlowSampler.run_standard_sampler),
        (FlowSampler.run_importance_nested_sampler, JaxFlowSampler.run_importance_nested_sampler),
        (NestedSampler.__init__, JaxNestedSampler.__init__),
        (ImportanceNestedSampler.__init__, JaxINS.__init__),
    ],
    ids=["FlowSampler", "run", "run_standard_sampler", "run_importance_nested_sampler", "NestedSampler",
         "ImportanceNestedSampler"],
)
def test_defaults_are_the_jax_packages(ours, theirs):
    """Every parameter the port takes has the JAX package's default (the
    port's own ``device``, ``poolsize`` and ``reparameterisation`` and
    its catch-all options aside)."""
    own = {"device", "poolsize", "reparameterisation", "options", "kwargs", "self"}
    theirs = inspect.signature(theirs).parameters
    for name, p in inspect.signature(ours).parameters.items():
        if name in own:
            continue
        assert name in theirs, name
        assert p.default == theirs[name].default, (name, p.default, theirs[name].default)


@pytest.mark.parametrize("dtype, error", [("float32", None), (None, None), ("float64", None)])
def test_torch_dtype(tmp_path, dtype, error):
    """The name is kept as the JAX package keeps it
    (``nessai_tpu/flowsampler.py:76-81``), which reads it nowhere: both
    packages' flows compute in float32 (``"float64"`` raised naming
    ROADMAP item 12 until the port took it)."""
    from nessai_tpu import config as jax_config

    kwargs = dict(output=str(tmp_path), nlive=50, torch_dtype=dtype, resume=False)
    assert error is None
    try:
        theirs = _fs("jax", **kwargs)
        ours = _fs("torch", **kwargs)
        assert ours.torch_dtype == theirs.torch_dtype == (dtype or "float32")
        ours.ns.flow_proposal.initialise()
        theirs.ns.flow_proposal.initialise()
        assert all(p.dtype == torch.float32 for p in ours.ns.flow_proposal.flow.flow.parameters())
        leaves = jax.tree_util.tree_leaves(theirs.ns.flow_proposal.flow.params)
        assert all(np.asarray(a).dtype == np.float32 for a in leaves if np.asarray(a).dtype.kind == "f")
    finally:
        jax_config.compute.default_dtype = "float32"


@pytest.mark.parametrize("entry", ["flowsampler", "nestedsampler", "importancesampler"])
def test_resume_without_gpu_raises_unless_on_the_cpu(standard_runs, tmp_path, monkeypatch, entry):
    """Resume follows the device rule: CUDA by default, so it raises
    without a GPU unless ``device="cpu"`` is passed."""
    if entry == "importancesampler":
        _ins_checkpoint("torch", str(tmp_path), levels=1)
        cls = ImportanceNestedSampler
    else:
        (tmp_path / "nested_sampler_resume.pkl").write_bytes(standard_runs["torch"][3])
        cls = NestedSampler
    path = str(tmp_path / "nested_sampler_resume.pkl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cpu"):
        kwargs = {} if device is None else {"device": device}
        if entry == "flowsampler":
            call = lambda: FlowSampler(IntegrationTestModel(2), output=str(tmp_path), resume=True,  # noqa: E731
                                       signal_handling=False, flow_config=FLOW, **kwargs)
        else:
            call = lambda: cls.resume(path, IntegrationTestModel(2), flow_config=FLOW, **kwargs)  # noqa: E731
        if device is None:
            with pytest.raises(RuntimeError, match="GPU"):
                call()
        else:
            out = call()
            ns = out.ns if entry == "flowsampler" else out
            assert ns.device == torch.device("cpu") and ns.iteration > 0
