"""Stepping on the device in the port
(``NestedSampler._consume_from_pool_device`` with the scan chained onto
the device populates) against the host paths and the JAX package: the
committed state bit for bit that of the host batched pass and of the
sequential ``consume_sample``, at the default tolerance and with
``max_iteration`` inside a pool; stale live sets and logL that float32
cannot hold refused; a partial fill discards the chained scan; the
scratch stays out of pickles; and both packages bit for bit with each
bookkeeping flag off. Mirrors the JAX package's
``tests/test_device_ns_loop.py`` and ``tests/test_chained_ns_scan.py``."""

import os
import pickle
import signal

import numpy as np
import pytest
import torch

from nessai_tpu.samplers.nestedsampler import NestedSampler as JaxNestedSampler
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.proposal import FlowProposal
from nessai_tpu_torch.proposal.flowproposal.flowproposal import device_loop_counts
from nessai_tpu_torch.proposal.rejection import prior_populate_counts
from nessai_tpu_torch.samplers.nestedsampler import NestedSampler
from nessai_tpu_torch.samplers.ns_device import run_ns_scan
from nessai_tpu_torch.utils.testing import IntegrationTestModel
from tests.test_torch_sampler import _live_and_pool, _prime


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _model():
    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(20260819))
    return model


def _run(tmp_path, tag, max_iteration=500, nlive=100, maximum_uninformed=50, checkpointing=False, **kwargs):
    ns = NestedSampler(
        _model(),
        nlive=nlive,
        output=str(tmp_path / tag),
        seed=2718,
        plot=False,
        checkpointing=checkpointing,
        maximum_uninformed=maximum_uninformed,
        max_iteration=max_iteration,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
        training_config=dict(max_epochs=10, patience=5, batch_size=100),
        poolsize=100,
        device="cpu",
        **kwargs,
    )
    ns.nested_sampling_loop()
    return ns


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same run with each way of consuming the pools: one run each,
    shared by the module's tests."""
    torch.set_num_threads(2)
    path = tmp_path_factory.mktemp("runs")
    counts = (device_loop_counts.chained_scans, prior_populate_counts.chained_scans)
    out = dict(
        host=_run(path, "host", device_bookkeeping=False),
        device=_run(path, "device"),
        sequential=_run(path, "sequential", batched_bookkeeping=False, device_bookkeeping=False),
        host_tol=_run(path, "host_tol", max_iteration=None, device_bookkeeping=False),
        device_tol=_run(path, "device_tol", max_iteration=None),
        host_cap=_run(path, "host_cap", max_iteration=333, device_bookkeeping=False),
        device_cap=_run(path, "device_cap", max_iteration=333),
    )
    out["chained"] = (device_loop_counts.chained_scans - counts[0], prior_populate_counts.chained_scans - counts[1])
    # an uninformed phase long enough to populate the prior again
    counts = prior_populate_counts.chained_scans
    out["host_prior"] = _run(path, "host_prior", max_iteration=300, maximum_uninformed=250, device_bookkeeping=False)
    out["device_prior"] = _run(path, "device_prior", max_iteration=300, maximum_uninformed=250)
    out["chained_prior"] = prior_populate_counts.chained_scans - counts
    return out


def _assert_same_run(a, b):
    _assert_same_state(a, b)
    assert b.model.likelihood_evaluations == a.model.likelihood_evaluations


def _assert_same_state(a, b):
    assert b.iteration == a.iteration
    assert b.accepted == a.accepted
    assert b.rejected == a.rejected
    assert b.insertion_indices == a.insertion_indices
    for attr in ("logZ", "logw", "oldZ", "logLs", "log_vols", "nlives", "nonmonotonic_count"):
        assert getattr(b.state, attr) == getattr(a.state, attr), attr
    assert np.array_equal(b.state.info, a.state.info)
    assert b.condition == a.condition
    assert b.logLmin == a.logLmin
    assert b.logLmax == a.logLmax
    ns_a = np.asarray(a.nested_samples, dtype=a.live_points.dtype)
    ns_b = np.asarray(b.nested_samples, dtype=b.live_points.dtype)
    for name in ns_a.dtype.names:
        assert np.array_equal(ns_a[name], ns_b[name]), name
    for name in a.live_points.dtype.names:
        assert np.array_equal(a.live_points[name], b.live_points[name]), name
    assert b.rolling_p == a.rolling_p
    for key in ("logZ", "dlogZ", "logLmin", "logLmax", "mean_acceptance", "iterations", "likelihood_evaluations"):
        assert b.history[key] == a.history[key], key
    assert b.mean_block_acceptance == a.mean_block_acceptance
    assert b.block_acceptance == a.block_acceptance
    assert b.block_iteration == a.block_iteration


def test_device_stepping_fires_in_both_phases(runs):
    assert getattr(runs["device"], "_n_device_steps", 0) > 0
    assert getattr(runs["host"], "_n_device_steps", 0) == 0
    assert getattr(runs["sequential"], "_n_device_steps", 0) == 0
    # scans chained onto the flow's device loop, and onto the prior
    # populate where the uninformed phase outlasts its first pool
    assert runs["chained"][0] > 0 and runs["chained_prior"] > 0


@pytest.mark.parametrize(
    "pair", [("host", "device"), ("sequential", "device"), ("sequential", "host"), ("host_prior", "device_prior")]
)
def test_device_commit_bit_exact(runs, pair):
    """At a cap that lands between pools: the device commit against the
    host batched pass and the sequential consume_sample."""
    _assert_same_run(runs[pair[0]], runs[pair[1]])


def test_device_commit_bit_exact_to_tolerance(runs):
    """No cap: dlogZ reaches the tolerance inside a pool, so the scan runs
    again on its own with the exact accept cap."""
    a, b = runs["host_tol"], runs["device_tol"]
    assert b.condition <= b.tolerance
    assert getattr(b, "_n_device_steps", 0) > 0
    _assert_same_run(a, b)
    assert abs(b.state.logZ - a.model.analytic_log_evidence) < 1.0


def test_device_commit_max_iteration_mid_pool(runs):
    a, b = runs["host_cap"], runs["device_cap"]
    assert b.iteration == a.iteration == 333
    _assert_same_run(a, b)


def test_eligibility_rejects_non_f32_values(tmp_path):
    """logL values that float32 cannot hold keep the host pass: float32
    comparisons could order them otherwise."""
    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(3))
    ns = NestedSampler(model, nlive=50, output=str(tmp_path), seed=1, plot=False, checkpointing=False,
                       maximum_uninformed=10, max_iteration=20, poolsize=50, device="cpu")
    ns.initialise(live_points=True)
    ns.uninformed_sampling = False
    ns.completed_training = True

    class FakeProposal:
        pass

    prop = FakeProposal()
    samples = ns.live_points.copy()[:50]
    samples["logL"] = np.random.default_rng(0).normal(size=50) + np.pi * 1e-9
    prop.samples = samples
    prop.indices = list(range(50))
    prop.populated = True
    ns.proposal = prop
    assert ns._device_step_eligible() is None
    samples["logL"] = np.float32(samples["logL"]).astype(np.float64)
    assert ns._device_step_eligible() is not None
    ns.device_bookkeeping = False
    assert ns._device_step_eligible() is None


def test_consume_rejects_stale_live_set(tmp_path):
    """A scan computed against another live set is discarded; the host
    batched pass then consumes the pool."""
    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(4))
    ns = NestedSampler(model, nlive=50, output=str(tmp_path), seed=1, plot=False, checkpointing=False,
                       maximum_uninformed=10, max_iteration=200, poolsize=50,
                       flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
                       training_config=dict(max_epochs=5, patience=3, batch_size=64), device="cpu")
    ns.initialise(live_points=True)
    ns.uninformed_sampling = False
    ns.proposal = ns._flow_proposal
    ns.train_proposal(force=True)
    assert not ns.proposal.populated
    ns._maybe_populate_for_device()
    assert ns.proposal.populated
    pending = ns.proposal._pending_ns_scan
    assert pending is not None
    pending["live32"] = pending["live32"] + np.float32(1.0)
    assert ns._consume_from_pool_device() is False
    assert ns.proposal._pending_ns_scan is None
    assert ns.proposal.populated
    assert ns._consume_from_pool_batched() is True


@pytest.fixture()
def trained_fp(tmp_path):
    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(11))
    model.device = "cpu"
    fp = FlowProposal(model, output=str(tmp_path), poolsize=100, flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1),
                      training_config=dict(max_epochs=5, batch_size=128, patience=3), populate_mode="device_loop",
                      rng=np.random.default_rng(5), plot=False, device="cpu")
    fp.initialise()
    x = model.new_point(256)
    x["logL"] = model.batch_evaluate_log_likelihood(x)
    fp.train(x, plot=False)
    return model, fp, x


def _scan_request(fp, n_live=32, max_acc=2**31 - 1):
    live32 = np.sort(np.random.default_rng(3).normal(size=n_live)).astype(np.float32)
    fp._ns_scan_request = (live32, max_acc)
    return live32


def test_chained_scan_produced_on_full_fill(trained_fp):
    """The chained scan saw the pool in its pop order: it equals the scan
    run on its own."""
    model, fp, x = trained_fp
    live32 = _scan_request(fp)
    try:
        fp.populate(x[0], n_samples=100)
    finally:
        fp._ns_scan_request = None
    pending = fp._pending_ns_scan
    assert pending is not None and pending["mask"].shape == (100,)
    assert np.array_equal(pending["live32"], live32) and pending["max_acc"] == 2**31 - 1
    assert sorted(fp.indices) == list(range(100))
    pool32 = fp.samples["logL"][fp.indices[::-1]].astype(np.float32)
    mask, consumed, ins, ids_f, n_acc = run_ns_scan(live32, pool32, 2**31 - 1, device="cpu")
    for key, value in (("mask", mask), ("consumed", consumed), ("ins", ins), ("final_ids", ids_f)):
        assert np.array_equal(value, pending[key]), key
    assert n_acc == pending["n_acc"]


def test_partial_fill_discards_scan_and_filters_perm(trained_fp):
    """A pool that cannot fill leaves no scan, and its pop order is the
    capacity's permutation restricted to the filled rows."""
    model, fp, x = trained_fp
    fp.max_samples = 512
    fp._max_samples_explicit = True
    # most draws leave the prior box at this temperature
    fp.latent_temperature = 25.0
    _scan_request(fp)
    try:
        fp.populate(x[0], n_samples=100)
    finally:
        fp._ns_scan_request = None
    assert len(fp.samples) < 100
    assert fp._pending_ns_scan is None
    idx = np.asarray(fp.indices)
    assert idx.size == len(fp.samples)
    assert np.array_equal(np.sort(idx), np.arange(len(fp.samples)))


def test_no_request_no_pending(trained_fp):
    model, fp, x = trained_fp
    fp.populate(x[0], n_samples=100)
    assert fp._pending_ns_scan is None
    assert sorted(fp.indices) == list(range(100))


def test_scratch_not_pickled(trained_fp):
    model, fp, x = trained_fp
    _scan_request(fp)
    try:
        fp.populate(x[0], n_samples=100)
    finally:
        fp._ns_scan_request = None
    assert fp._pending_ns_scan is not None
    state = fp.__getstate__()
    for key in ("_pending_ns_scan", "_ns_scan_request", "_early_perm"):
        assert key not in state, key
    pickle.dumps(state)


def test_a_signal_waits_for_the_end_of_a_device_commit(tmp_path, monkeypatch):
    """A checkpointing signal that arrives inside a device commit (here
    at a history boundary, where ``update_state`` runs) is handled once
    the commit has ended: its handler, which would pickle the sampler,
    sees the state at the end of the pool, not the pool's final live set
    beside an earlier iteration."""
    sent, seen, ends, sampler, inside = [], [], [], [], []
    commit, update = NestedSampler._consume_from_pool_device, NestedSampler.update_state

    def counted_commit(self):
        sampler[:] = [self]
        inside.append(True)
        try:
            done = commit(self)
        finally:
            inside.pop()
        if done:
            ends.append(self.iteration)
        return done

    def signalling_update(self, *args, **kwargs):
        if inside and not sent:
            sent.append(self.iteration)
            os.kill(os.getpid(), signal.SIGALRM)
        return update(self, *args, **kwargs)

    monkeypatch.setattr(NestedSampler, "_consume_from_pool_device", counted_commit)
    monkeypatch.setattr(NestedSampler, "update_state", signalling_update)
    previous = signal.signal(signal.SIGALRM, lambda signum, frame: seen.append(sampler[0].iteration))
    try:
        _run(tmp_path, "signal", max_iteration=300)
    finally:
        signal.signal(signal.SIGALRM, previous)
    assert sent and len(seen) == 1
    assert seen[0] in ends and seen[0] > sent[0]


def test_a_periodic_checkpoint_waits_for_the_end_of_a_device_commit(tmp_path):
    """A periodic checkpoint that falls due inside a device commit (every
    25 iterations here, which lands at history boundaries inside the
    pools) is written at the commit's end, once the state is whole: each
    pickle holds the sequential run's state at its iteration, and a run
    resumed from one ends bit for bit as a run resumed from the sequential
    run's pickle at that iteration. (A resumed run draws a fresh pool, as
    the pickle holds none, so it is not the uninterrupted run.)"""
    def recorder(pickles, keep=None):
        def callback(sampler):
            if keep is None or sampler.iteration in keep:
                pickles[sampler.iteration] = pickle.dumps(sampler)

        return callback

    device, sequential = {}, {}
    ckpt = dict(checkpointing=True, checkpoint_on_iteration=True)
    ns = _run(tmp_path, "device", checkpoint_interval=25, checkpoint_callback=recorder(device), **ckpt)
    assert getattr(ns, "_n_device_steps", 0) > 0 and len(device) > 3
    _run(tmp_path, "sequential", checkpoint_interval=1, checkpoint_callback=recorder(sequential, set(device)),
         batched_bookkeeping=False, device_bookkeeping=False, **ckpt)
    assert set(sequential) == set(device)
    for it in sorted(device):
        a, b = pickle.loads(sequential[it]), pickle.loads(device[it])
        _assert_same_state(a, b)
        assert b.rng.bit_generator.state == a.rng.bit_generator.state
        assert b._previous_likelihood_evaluations == a._previous_likelihood_evaluations

    it = sorted(device)[len(device) // 2]
    resumed = []
    for tag, pickles in (("sequential", sequential), ("device", device)):
        ns = NestedSampler.resume_from_pickled_sampler(pickle.loads(pickles[it]), _model(),
                                                       output=str(tmp_path / f"resumed_{tag}"), device="cpu")
        ns.nested_sampling_loop()
        resumed.append(ns)
    assert resumed[1].iteration == 500
    _assert_same_run(*resumed)


def test_resumed_pickles_take_the_defaults(tmp_path):
    """A sampler pickle without ``device_bookkeeping`` steps on the device,
    and a proposal without ``_max_samples_explicit`` keeps its exact cap,
    as the JAX package resumes its older pickles."""
    ns = NestedSampler(IntegrationTestModel(2), nlive=50, output=str(tmp_path), plot=False, checkpointing=False,
                       device="cpu")
    state = ns.__getstate__()
    del state["device_bookkeeping"]
    resumed = NestedSampler.__new__(NestedSampler)
    resumed.__setstate__(state)
    assert resumed.device_bookkeeping is True
    proposal = resumed._flow_proposal
    del proposal._max_samples_explicit
    assert getattr(proposal, "_max_samples_explicit", True) is True


class _JaxHostModel(JaxModel):
    jax_log_likelihood = None


class _HostModel(IntegrationTestModel):
    torch_log_likelihood = None


@pytest.mark.parametrize(
    "flags", [dict(device_bookkeeping=False), dict(batched_bookkeeping=False, device_bookkeeping=False)], ids=str
)
def test_both_packages_bit_for_bit_with_each_flag_off(tmp_path, flags):
    """A whole run of the uninformed phase from one seed (host
    likelihoods, so both packages draw every pool from the host stream):
    the two packages' states bit for bit with each flag off."""
    runs = []
    for cls, model_cls, extra in ((JaxNestedSampler, _JaxHostModel, {}), (NestedSampler, _HostModel, dict(device="cpu"))):
        model = model_cls(2)
        model.set_rng(np.random.default_rng(5))
        ns = cls(model, nlive=100, output=str(tmp_path / cls.__module__), seed=21, plot=False, checkpointing=False,
                 maximum_uninformed=1000, max_iteration=400, uninformed_acceptance_threshold=0.0, poolsize=100,
                 **flags, **extra)
        ns.nested_sampling_loop()
        runs.append(ns)
    a, b = runs
    assert a.iteration == b.iteration == 400 and a.uninformed_sampling and b.uninformed_sampling
    for attr in ("accepted", "rejected", "insertion_indices", "condition", "logLmin", "logLmax",
                 "block_acceptance", "mean_block_acceptance"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for attr in ("logZ", "logw", "oldZ", "logLs", "log_vols", "info"):
        assert getattr(a.state, attr) == getattr(b.state, attr), attr
    for name in a.live_points.dtype.names:
        assert np.array_equal(a.live_points[name], b.live_points[name]), name
    assert a.model.likelihood_evaluations == b.model.likelihood_evaluations


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("batched", [True, False])
def test_flow_phase_pool_bit_for_bit_with_each_flag_off(tmp_path, seed, batched):
    """One flow-phase pool with ties given to both packages: the batched
    pass (``device_bookkeeping=False``) or ``consume_sample`` an iteration
    at a time (``batched_bookkeeping=False``), to the last accept before
    the pool runs out, bit for bit."""
    common = dict(nlive=50, seed=5, plot=False, checkpointing=False, poolsize=50, device_bookkeeping=False,
                  batched_bookkeeping=batched)
    jns = JaxNestedSampler(JaxModel(2), output=str(tmp_path / "jax"), **common)
    tns = NestedSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), device="cpu", **common)
    live, pool, order = _live_and_pool(tns, seed)
    pool32 = pool["logL"][order[::-1]].astype(np.float32)
    n_acc = run_ns_scan(live["logL"].astype(np.float32), pool32, 2**31 - 1, device="cpu")[4]
    for ns in (jns, tns):
        _prime(ns, live, pool, order)
        if batched:
            assert ns._consume_from_pool_batched()
        else:
            for _ in range(n_acc - 1):
                ns.consume_sample()
                ns.iteration += 1
                ns.block_iteration += 1
                ns.update_state()
    assert tns.iteration == jns.iteration > 0
    assert tns.insertion_indices == jns.insertion_indices
    assert tns.proposal.indices == jns.proposal.indices
    for attr in ("accepted", "condition", "logLmin", "logLmax", "block_acceptance", "mean_block_acceptance"):
        assert getattr(tns, attr) == getattr(jns, attr), attr
    for attr in ("logZ", "logw", "oldZ", "logLs", "log_vols", "info"):
        assert getattr(tns.state, attr) == getattr(jns.state, attr), attr
    assert np.array_equal(np.asarray(tns.nested_samples), np.asarray(jns.nested_samples))
    assert np.array_equal(tns.live_points, jns.live_points)
