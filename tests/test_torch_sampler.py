"""The port's sampler against the JAX package's: the batched
consume/insert pass bit for bit, the evidence state and its simulated
error, and a whole run on the CPU at the statistical level."""

import numpy as np
import pytest
import torch

from nessai_tpu.evidence import _NSIntegralState as JaxState
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.samplers.nestedsampler import NestedSampler as JaxNestedSampler
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.evidence import _NSIntegralState
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.samplers.nestedsampler import NestedSampler
from nessai_tpu_torch.utils.testing import IntegrationTestModel

NLIVE = 50


def _samplers(tmp_path):
    common = dict(nlive=NLIVE, seed=5, plot=False, checkpointing=False, poolsize=NLIVE)
    jm, tm = JaxModel(2), IntegrationTestModel(2)
    jns = JaxNestedSampler(jm, output=str(tmp_path / "jax"), **common)
    tns = NestedSampler(tm, output=str(tmp_path / "torch"), device="cpu", **common)
    return jns, tns


def _live_and_pool(ns, seed):
    """Live points and a pool whose float32-rounded logL values tie with
    each other and with the live points."""
    rng = np.random.default_rng(seed)
    names = ns.model.names
    live = np.zeros(NLIVE, dtype=ns._uninformed_proposal.model.new_point(2).dtype)
    pool = np.zeros(300, dtype=live.dtype)
    for arr in (live, pool):
        for n in names:
            arr[n] = rng.normal(size=arr.size)
        arr["logP"] = -np.log(400.0)
    live_l = np.float32(-rng.exponential(3.0, NLIVE)).astype(np.float64)
    pool_l = np.float32(-rng.exponential(2.0, 300)).astype(np.float64)
    pool_l[::7] = live_l[rng.integers(0, NLIVE, pool_l[::7].size)]
    pool_l[1::11] = pool_l[2::11][: pool_l[1::11].size]
    live["logL"] = live_l
    pool["logL"] = pool_l
    live["it"] = -1
    live = np.sort(live, order="logL")
    return live, pool, rng.permutation(300).tolist()


def _prime(ns, live, pool, order):
    ns.initialise_history()
    ns.live_points = live.copy()
    ns.logLmax = float(live["logL"][-1])
    ns.uninformed_sampling = False
    ns.proposal = ns._flow_proposal
    ns.proposal.samples = pool.copy()
    ns.proposal.indices = list(order)
    ns.proposal.populated = True
    ns._yield_iter = ns.yield_sample(ns.live_points[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_consume_is_bit_exact(tmp_path, seed):
    jns, tns = _samplers(tmp_path)
    live, pool, order = _live_and_pool(tns, seed)
    for ns in (jns, tns):
        _prime(ns, live, pool, order)
        assert ns._consume_from_pool_batched()
    assert tns.iteration == jns.iteration > 0
    assert tns.insertion_indices == jns.insertion_indices
    assert tns.proposal.indices == jns.proposal.indices
    for attr in ("accepted", "condition", "logLmin", "logLmax", "block_acceptance", "mean_block_acceptance"):
        assert getattr(tns, attr) == getattr(jns, attr), attr
    for attr in ("logZ", "logw", "oldZ", "logLs", "log_vols", "info"):
        assert getattr(tns.state, attr) == getattr(jns.state, attr), attr
    ns_t = np.asarray(tns.nested_samples)
    ns_j = np.asarray(jns.nested_samples)
    assert np.array_equal(ns_t, ns_j)
    assert np.array_equal(tns.live_points, jns.live_points)
    assert tns.history["logZ"] == jns.history["logZ"]
    assert tns.history["dlogZ"] == jns.history["dlogZ"]
    assert tns.rolling_p == jns.rolling_p


def _synthetic_run(state_cls, n_nats, nlive=100):
    """A run whose likelihood rises by 2 nats per nat of compression, so
    the posterior mass sits at log X = -n_nats."""
    state = state_cls(nlive)
    n_iter = n_nats * nlive
    for i in range(n_iter):
        state.increment(2.0 * i / nlive)
    for i in range(nlive):
        state.increment(2.0 * n_iter / nlive + 1e-3 * (i + 1), nlive=nlive - i)
    state.finalise()
    return state


def test_evidence_state_matches_jax():
    ours, theirs = _synthetic_run(_NSIntegralState, 20), _synthetic_run(JaxState, 20)
    assert ours.logZ == theirs.logZ
    assert ours.logLs == theirs.logLs and ours.log_vols == theirs.log_vols
    assert ours.info == theirs.info
    np.testing.assert_array_equal(ours.log_posterior_weights(), theirs.log_posterior_weights())


def test_simulated_error_matches_jax_below_80_nats():
    ours, theirs = _synthetic_run(_NSIntegralState, 60), _synthetic_run(JaxState, 60)
    a = ours.simulate_log_evidence(400, rng=np.random.default_rng(3))
    b = theirs.simulate_log_evidence(400, rng=np.random.default_rng(3))
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    # the same float32 exponential draws; float64 against float32 scratch
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.std(a), np.std(b), rtol=1e-4)


def test_simulated_error_is_finite_beyond_87_nats():
    state = _synthetic_run(_NSIntegralState, 120)
    draws = state.simulate_log_evidence(200, rng=np.random.default_rng(4))
    assert np.all(np.isfinite(draws))
    sigma = float(np.std(draws))
    assert np.isfinite(sigma) and 0.0 < sigma < 10 * state.log_evidence_error


def _end_to_end_agrees_with_jax(tmp_path, **flow_config):
    """A whole run of each package on the CPU: both within 3 sigma of the
    analytic evidence and of each other."""
    torch.set_float32_matmul_precision("highest")
    kwargs = dict(
        nlive=200,
        seed=1234,
        plot=False,
        checkpointing=False,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1, **flow_config),
        training_config=dict(max_epochs=20, patience=10, batch_size=200),
        poolsize=200,
    )
    tmodel = IntegrationTestModel(2)
    tfs = FlowSampler(tmodel, output=str(tmp_path / "torch"), device="cpu", **kwargs)
    t_logz, t_ns = tfs.run(plot=False, save=False)
    t_err = tfs.logZ_error
    jfs = JaxFlowSampler(JaxModel(2), output=str(tmp_path / "jax"), resume=False, **kwargs)
    j_logz, _ = jfs.run(plot=False, save=False)
    j_err = jfs.logZ_error
    analytic = tmodel.analytic_log_evidence
    assert abs(t_logz - analytic) < 3 * t_err
    assert abs(j_logz - analytic) < 3 * j_err
    assert abs(t_logz - j_logz) < 3 * np.hypot(t_err, j_err)
    assert len(t_ns) == tfs.ns.iteration + 200
    assert tfs.ns.train_count > 0
    assert np.all(np.isfinite(tfs.posterior_samples["x_0"]))
    return tfs


def test_end_to_end_agrees_with_jax_on_cpu(tmp_path):
    _end_to_end_agrees_with_jax(tmp_path)


def test_nsf_end_to_end_agrees_with_jax_on_cpu(tmp_path):
    from nessai_tpu_torch.flows.bijectors import RQSCoupling

    tfs = _end_to_end_agrees_with_jax(tmp_path, ftype="nsf")
    flow = tfs.ns.flow_proposal.flow.flow
    assert sum(isinstance(b, RQSCoupling) for b in flow.bijector.bijectors) == 2


@pytest.mark.parametrize("seed", [2, 3])
def test_posterior_draws_match_jax(seed):
    from nessai_tpu.posterior import compute_weights as jax_weights
    from nessai_tpu.posterior import draw_posterior_samples as jax_draw
    from nessai_tpu_torch.posterior import compute_weights, draw_posterior_samples

    state = _synthetic_run(_NSIntegralState, 5, nlive=50)
    samples = np.zeros(len(state.logLs) - 1, dtype=[("x", "f8"), ("logL", "f8")])
    samples["logL"] = state.logLs[1:]
    samples["x"] = np.arange(samples.size)
    nlive = np.asarray(state.nlives, dtype=float)
    log_z, log_w = compute_weights(samples["logL"], nlive)
    jax_log_z, jax_log_w = jax_weights(samples["logL"], nlive)
    assert log_z == jax_log_z
    np.testing.assert_array_equal(log_w, jax_log_w)
    np.testing.assert_allclose(log_w, state.log_posterior_weights(), rtol=0, atol=1e-12)
    ours = draw_posterior_samples(samples, nlive, rng=np.random.default_rng(seed))
    theirs = jax_draw(
        samples, nlive, method="rejection_sampling", rng=np.random.default_rng(seed)
    )
    np.testing.assert_array_equal(ours, theirs)
