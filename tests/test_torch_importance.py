"""The port's importance nested sampler against the JAX package's.

- Module level: the per-level flows (``ImportanceFlowModel``) and the
  meta-proposal (``ImportanceFlowProposal``) of both packages, given the
  same converted weights at every level, on the same 1000 rows: within
  atol 1e-5 + rtol 1e-5 (float32 flows, float64 results).
- Trajectory level: the host bookkeeping (``OrderedSamples``, both
  threshold rules, ``remove_samples``, ``_INSIntegralState``, the ratio
  criterion) driven by one numpy-seeded sequence of levels: thresholds,
  removed counts and sample arrays equal, evidence and criteria within
  1e-12; the host utilities equal.
- Statistical level: whole runs on the CPU against the analytic evidence
  of the 2-D Gaussian.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.flowmodel.importance import ImportanceFlowModel as JaxImportanceFlowModel
from nessai_tpu.livepoint import numpy_array_to_live_points as jax_to_live_points
from nessai_tpu.posterior import draw_posterior_samples as jax_draw_posterior_samples
from nessai_tpu.proposal.importance import ImportanceFlowProposal as JaxImportanceFlowProposal
from nessai_tpu.samplers.importancesampler import ImportanceNestedSampler as JaxINS
from nessai_tpu.stopping_criteria import StoppingCriterionRegistry as JaxRegistry
from nessai_tpu.utils import information as jax_information
from nessai_tpu.utils import rescaling as jax_rescaling
from nessai_tpu.utils import stats as jax_stats
from nessai_tpu.utils import structures as jax_structures
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch import config
from nessai_tpu_torch.evidence import log_evidence_from_ins_samples
from nessai_tpu_torch.flowmodel import ImportanceFlowModel
from nessai_tpu_torch.flows import params_to_jax
from nessai_tpu_torch.flows.bijectors import ActNorm, AffineCoupling, Permutation
from nessai_tpu_torch.flows.convert import levels_from_jax
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.model import Model, UniformPriorMixin
from nessai_tpu_torch.posterior import draw_posterior_samples
from nessai_tpu_torch.proposal import ImportanceFlowProposal
from nessai_tpu_torch.samplers import ImportanceNestedSampler
from nessai_tpu_torch.stopping_criteria import StoppingCriterionRegistry
from nessai_tpu_torch.utils import information, rescaling, stats, structures
from nessai_tpu_torch.utils.testing import IntegrationTestModel, time_limit as _time_limit

#: the small flow of the tests: 2 blocks × 1 layer × 16 neurons
FLOW_CONFIG = dict(n_blocks=2, n_neurons=16, n_layers=1)
#: module-level tolerance: float32 flows on both sides
ATOL = RTOL = 1e-5
#: trajectory-level tolerance of the evidence and the criteria
EXACT = 1e-12
N_ROWS = 1000


@pytest.fixture(autouse=True)
def _highest_precision_and_clean_fields():
    torch.set_float32_matmul_precision("highest")
    yield
    config.livepoints.reset()


def _perturbed(params, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + rng.normal(0.0, scale, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, params),
    )


def _jax_levels(jfm, n_levels=3, seed=10):
    """``n_levels`` perturbed copies of a fresh JAX flow, as numpy pytrees."""
    levels = [_perturbed(jfm.params, seed + i) for i in range(n_levels)]
    jfm.params_list = [jax.tree.map(jnp.asarray, p) for p in levels]
    jfm._stacked = None
    return levels


def _prime_rows(seed=3):
    # logit-space rows as the flows see them: most near the origin, some
    # far out where a level puts little mass
    return 2.0 * np.random.default_rng(seed).standard_normal((N_ROWS, 2))


def _flow_pair(tmp_path, seed=0):
    cfg = dict(FLOW_CONFIG, n_inputs=2)
    jfm = JaxImportanceFlowModel(cfg, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed))
    jfm.initialise()
    levels = _jax_levels(jfm)
    tfm = ImportanceFlowModel(cfg, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed), device="cpu")
    tfm.initialise()
    levels_from_jax(tfm, levels)
    return jfm, tfm, levels


# ----------------------------------------------------------------------
# Module level
# ----------------------------------------------------------------------
def test_levels_convert_weight_for_weight(tmp_path):
    _, tfm, levels = _flow_pair(tmp_path)
    assert tfm.n_models == 3
    for level, params in zip(tfm.models, levels):
        ours = params_to_jax(level)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not any(p.requires_grad for p in level.parameters())


def test_log_prob_all_and_ith_match_jax(tmp_path):
    jfm, tfm, _ = _flow_pair(tmp_path)
    x = _prime_rows()
    ours = tfm.log_prob_all(x)
    theirs = jfm.log_prob_all(x)
    assert ours.shape == theirs.shape == (N_ROWS, 3) and ours.dtype == np.float64
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL)
    for i in range(3):
        np.testing.assert_allclose(tfm.log_prob_ith(x, i), jfm.log_prob_ith(x, i), atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(tfm.log_prob_ith(x, i), ours[:, i])


def _proposal_pair(tmp_path, seed=0):
    jax_model, model = JaxModel(2), IntegrationTestModel(2)
    for m in (jax_model, model):
        m.set_rng(np.random.default_rng(seed))
    jp = JaxImportanceFlowProposal(
        jax_model, output=str(tmp_path / "jax"), flow_config=FLOW_CONFIG,
        weighted_kl=False, rng=np.random.default_rng(seed),
    )
    jp.flow.initialise()
    levels = _jax_levels(jp.flow)
    tp = ImportanceFlowProposal(
        model, output=str(tmp_path / "torch"), flow_config=FLOW_CONFIG,
        rng=np.random.default_rng(seed), device="cpu",
    )
    tp.flow.initialise()
    levels_from_jax(tp.flow, levels)
    weights = {-1: 0.4, 0: 0.3, 1: 0.2, 2: 0.1}
    for p in (jp, tp):
        p.level_count = 2
        p.update_proposal_weights(weights)
    return jp, tp


def test_compute_log_Q_matches_jax(tmp_path):
    jp, tp = _proposal_pair(tmp_path)
    u = np.random.default_rng(5).uniform(size=(N_ROWS, 2))
    x_prime, log_j = tp.to_prime(u)
    j_prime, j_log_j = jp.to_prime(u)
    np.testing.assert_array_equal(x_prime, j_prime)
    np.testing.assert_array_equal(log_j, j_log_j)
    log_Q, log_q = tp.compute_log_Q(x_prime, log_j)
    j_log_Q, j_log_q = jp.compute_log_Q(x_prime, log_j)
    assert log_q.shape == (N_ROWS, 4)
    np.testing.assert_array_equal(log_q[:, 0], 0.0)
    np.testing.assert_allclose(log_q, j_log_q, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(log_Q, j_log_Q, atol=ATOL, rtol=RTOL)
    log_Q_s, log_q_s = tp.compute_meta_proposal_samples(numpy_array_to_live_points(u, tp.model.names))
    np.testing.assert_array_equal(log_Q_s, log_Q)
    np.testing.assert_array_equal(log_q_s, log_q)
    # the meta-proposal of the same matrix is the same float64 arithmetic
    np.testing.assert_array_equal(tp.compute_meta_proposal_from_log_q(j_log_q), jp.compute_meta_proposal_from_log_q(j_log_q))


def test_update_log_q_matches_jax(tmp_path):
    jp, tp = _proposal_pair(tmp_path)
    u = np.random.default_rng(6).uniform(size=(N_ROWS, 2))
    log_q = np.random.default_rng(7).normal(size=(N_ROWS, 3))
    ours = tp.update_log_q(numpy_array_to_live_points(u, tp.model.names), log_q)
    theirs = jp.update_log_q(jax_to_live_points(u, jp.model.names), log_q)
    assert ours.shape == (N_ROWS, 4)
    np.testing.assert_array_equal(ours[:, :3], log_q)
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="already contains"):
        tp.update_log_q(numpy_array_to_live_points(u, tp.model.names), ours)


def test_draws_are_inside_the_hypercube_with_their_meta_density(tmp_path):
    ImportanceNestedSampler.add_fields()
    _, tp = _proposal_pair(tmp_path)
    samples, log_q = tp.draw(500)
    assert len(samples) == 500 and log_q.shape == (500, 4)
    x = np.stack([samples[n] for n in tp.model.names], axis=1)
    assert ((x > 0) & (x < 1)).all()
    x_prime, log_j = tp.rescale(samples)
    log_Q, log_q_again = tp.compute_log_Q(x_prime, log_j)
    np.testing.assert_allclose(log_q_again, log_q, atol=1e-9)
    np.testing.assert_allclose(samples["logQ"], log_Q, atol=1e-9)
    np.testing.assert_array_equal(samples["logW"], samples["logU"] - samples["logQ"])


def test_add_new_flow_resets_or_copies(tmp_path):
    tfm = ImportanceFlowModel(dict(FLOW_CONFIG, n_inputs=2), output=str(tmp_path), rng=np.random.default_rng(1), device="cpu")
    x = np.random.default_rng(2).normal(2.0, 3.0, (400, 2))
    tfm.add_new_flow(reset=True)
    assert not tfm._actnorm_done
    perms = [b.perm.clone() for b in tfm.flow.bijector.bijectors if isinstance(b, Permutation)]
    tfm.train(x, max_epochs=3)
    trained = {k: v.clone() for k, v in tfm.models[0].state_dict().items()}
    # a copied level starts from the last level and keeps its ActNorm
    tfm.add_new_flow(reset=False)
    assert tfm._actnorm_done
    for k, v in tfm.flow.state_dict().items():
        assert torch.equal(v, trained[k])
    # a fresh level: new weights from the generator, identity couplings,
    # ActNorm to be initialised again on its data, the same permutations
    tfm.add_new_flow(reset=True)
    assert not tfm._actnorm_done
    for b in tfm.flow.bijector.bijectors:
        if isinstance(b, AffineCoupling):
            assert torch.count_nonzero(b.net.final.weight) == 0
        elif isinstance(b, ActNorm):
            assert torch.count_nonzero(b.log_scale) == 0
    assert all(
        torch.equal(b.perm, p)
        for b, p in zip((b for b in tfm.flow.bijector.bijectors if isinstance(b, Permutation)), perms)
    )
    # the frozen level is untouched by later training
    tfm.train(x, max_epochs=3)
    assert tfm.n_models == 2
    for k, v in tfm.models[0].state_dict().items():
        assert torch.equal(v, trained[k])


# ----------------------------------------------------------------------
# Trajectory level (host, exact)
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "name",
    ["logit", "sigmoid", "weighted_quantile", "differential_entropy", "effective_sample_size"],
)
def test_host_utilities_equal_jax(name):
    rng = np.random.default_rng(11)
    u = rng.uniform(size=(500, 2))
    u[0, 0], u[1, 1] = 0.0, 1.0
    log_w = rng.normal(0, 3, 500)
    if name == "logit":
        ours, theirs = rescaling.logit(u), jax_rescaling.logit(u)
    elif name == "sigmoid":
        z = rng.normal(0, 5, (500, 2))
        ours, theirs = rescaling.sigmoid(z), jax_rescaling.sigmoid(z)
    elif name == "weighted_quantile":
        v = np.sort(rng.normal(size=500))
        args = (v, [0.1, 0.5, 0.8])
        ours = stats.weighted_quantile(*args, log_weights=log_w, values_sorted=True)
        theirs = jax_stats.weighted_quantile(*args, log_weights=log_w, values_sorted=True)
    elif name == "differential_entropy":
        ours, theirs = information.differential_entropy(log_w), jax_information.differential_entropy(log_w)
    else:
        ours, theirs = stats.effective_sample_size(log_w), jax_stats.effective_sample_size(log_w)
    for a, b in zip(np.atleast_1d(ours), np.atleast_1d(theirs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "name", ["get_subset_arrays", "isfinite_struct", "array_split_chunksize", "get_inverse_indices", "replace_in_list"]
)
def test_structures_equal_jax(name):
    rng = np.random.default_rng(14)
    a = rng.normal(size=10)
    if name == "get_subset_arrays":
        args = (np.array([3, 1, 7]), a, 2 * a)
    elif name == "isfinite_struct":
        x = numpy_array_to_live_points(rng.normal(size=(6, 2)), ["x_0", "x_1"])
        x["x_1"][2] = np.inf
        args = (x, ["x_0", "x_1"])
    elif name == "array_split_chunksize":
        args = (a, 3)
    elif name == "get_inverse_indices":
        args = (10, np.array([0, 4, 9]))
    else:
        ours_list, theirs_list = ["a", "b", "c"], ["a", "b", "c"]
        structures.replace_in_list(ours_list, ["b"], ["z"])
        jax_structures.replace_in_list(theirs_list, ["b"], ["z"])
        assert ours_list == theirs_list == ["a", "z", "c"]
        return
    ours, theirs = getattr(structures, name)(*args), getattr(jax_structures, name)(*args)
    for o, t in zip(ours if isinstance(ours, (list, tuple)) else [ours], theirs if isinstance(theirs, (list, tuple)) else [theirs]):
        np.testing.assert_array_equal(o, t)


@pytest.mark.parametrize("method", ["importance_sampling", "multinomial_resampling", "rejection_sampling"])
def test_posterior_draw_with_log_weights_equals_jax(method):
    rng = np.random.default_rng(12)
    samples = numpy_array_to_live_points(rng.uniform(size=(800, 2)), ["x_0", "x_1"])
    samples["logL"] = rng.normal(size=800)
    log_w = rng.normal(0, 2, 800)
    ours = draw_posterior_samples(samples, log_w=log_w, method=method, rng=np.random.default_rng(4))
    theirs = jax_draw_posterior_samples(samples, log_w=log_w, method=method, rng=np.random.default_rng(4))
    assert len(ours) == len(theirs)
    for field in ("x_0", "x_1", "logL"):
        np.testing.assert_array_equal(ours[field], theirs[field])
    if method != "rejection_sampling":
        assert len(ours) == int(stats.effective_sample_size(log_w))


def test_stopping_criteria_registry_equals_jax():
    assert StoppingCriterionRegistry.known() == JaxRegistry.known()
    for name in StoppingCriterionRegistry.known():
        ours, theirs = StoppingCriterionRegistry.get(name), JaxRegistry.get(name)
        assert (ours.name, ours.tolerance, ours.comparison) == (theirs.name, theirs.tolerance, theirs.comparison)
        for value in (-1.0, 0.0, 0.05, 1e4):
            assert ours.is_met(value) == theirs.is_met(value)


def _samplers(tmp_path, **kwargs):
    kwargs = dict(nlive=1000, min_samples=200, seed=8, draw_iid_live=False, **kwargs)
    jns = JaxINS(JaxModel(2), output=str(tmp_path / "jax"), checkpointing=False, plot=False, **kwargs)
    tns = ImportanceNestedSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), checkpointing=False,
                                  plot=False, device="cpu", **kwargs)
    for ns in (jns, tns):
        ns.initialise_history()
    return jns, tns


def _structured(u, logL, it, log_q, to_live_points, proposal):
    s = to_live_points(u, ["x_0", "x_1"])
    s["logL"] = logL
    s["it"] = it
    s["logU"] = 0.0
    s["logQ"] = proposal.compute_meta_proposal_from_log_q(log_q)
    s["logW"] = s["logU"] - s["logQ"]
    return s


def _log_likelihood(u):
    x = 20.0 * u - 10.0
    return -0.5 * np.sum(x**2, axis=1) - np.log(2 * np.pi)


def _assert_same_store(a, b):
    for field in a.samples.dtype.names:
        np.testing.assert_array_equal(a.samples[field], b.samples[field], err_msg=field)
    np.testing.assert_array_equal(a.log_q, b.log_q)
    np.testing.assert_array_equal(a.is_nested, b.is_nested)


@pytest.mark.parametrize("strict_threshold", [False, True])
@pytest.mark.parametrize("method", ["entropy", "quantile"])
def test_level_trajectory_equals_jax(tmp_path, method, strict_threshold):
    """Five levels of new samples and log_q columns from one numpy seed,
    fed through both samplers' bookkeeping."""
    _level_trajectory(tmp_path, method=method, strict_threshold=strict_threshold)


def test_level_trajectory_with_replace_all_equals_jax(tmp_path):
    """The same five levels with ``replace_all``: every live point moves
    to the nested set at each level."""
    _level_trajectory(tmp_path, method="entropy", strict_threshold=False, replace_all=True)


def _level_trajectory(tmp_path, method, strict_threshold, replace_all=False):
    jns, tns = _samplers(
        tmp_path, threshold_method=method, strict_threshold=strict_threshold, replace_all=replace_all
    )
    rng = np.random.default_rng(20261017)
    n = 1000
    u = rng.uniform(size=(n, 2))
    log_q = np.zeros((n, 1))
    for ns, to_lp in ((jns, jax_to_live_points), (tns, numpy_array_to_live_points)):
        ns.sample_counts[-1] = n
        ns.training_samples.add_initial_samples(
            _structured(u, _log_likelihood(u), -1, log_q, to_lp, ns.proposal), log_q
        )
    width = 1.0
    for level in range(5):
        thresholds = [
            ns.determine_log_likelihood_threshold(ns.live_points_unit, method=method) for ns in (jns, tns)
        ]
        assert thresholds[0] == thresholds[1]
        removed = []
        for ns in (jns, tns):
            ns.update_log_likelihood_threshold(thresholds[1])
            removed.append(ns.remove_samples())
            ns.add_new_proposal_weight(level, n)
        assert removed[0] == removed[1]
        if replace_all:
            assert tns.live_points_unit is None and tns.training_samples.is_nested.all()
        np.testing.assert_array_equal(jns.proposal.weights_array, tns.proposal.weights_array)
        # the new level's column for the stored samples, and new samples
        # from a shrinking box around the peak with their log_q rows
        n_stored = len(tns.training_samples.samples)
        column = rng.normal(float(level), 1.0, (n_stored, 1))
        width *= 0.6
        u_new = 0.5 + width * (rng.uniform(size=(n, 2)) - 0.5)
        log_q_new = np.concatenate([np.zeros((n, 1)), rng.normal(1.0, 1.0, (n, level + 1))], axis=1)
        for ns, to_lp in ((jns, jax_to_live_points), (tns, numpy_array_to_live_points)):
            ordered = ns.training_samples
            ordered.log_q = np.concatenate([ordered.log_q, column], axis=1)
            ordered.samples["logQ"] = ns.proposal.compute_meta_proposal_from_log_q(ordered.log_q)
            ordered.samples["logW"] = ordered.samples["logU"] - ordered.samples["logQ"]
            new = _structured(u_new, _log_likelihood(u_new), level, log_q_new, to_lp, ns.proposal)
            ordered.add_samples(new, log_q_new)
            ns.update_evidence()
            ns.criterion = ns.compute_stopping_criterion()
        _assert_same_store(jns.training_samples, tns.training_samples)
        for attr in ("log_evidence", "log_evidence_error", "log_evidence_ratio",
                     "log_evidence_nested_samples", "log_evidence_live_points",
                     "effective_n_posterior_samples", "difference_log_evidence"):
            a, b = getattr(jns.state, attr), getattr(tns.state, attr)
            # equal where infinite (the first difference_log_evidence)
            assert a == b or abs(a - b) <= EXACT, (attr, a, b)
        assert abs(jns.criterion["log_evidence_ratio"] - tns.criterion["log_evidence_ratio"]) <= EXACT
        assert jns.reached_tolerance == tns.reached_tolerance
        np.testing.assert_allclose(
            tns.compute_importance()["total"], jns.compute_importance()["total"], atol=EXACT, rtol=0
        )
        assert abs(
            tns.training_samples.compute_evidence_ratio() - jns.training_samples.compute_evidence_ratio()
        ) <= EXACT
    for ns in (jns, tns):
        ns.finalise()
    _assert_same_store(jns.training_samples, tns.training_samples)
    assert abs(jns.log_evidence - tns.log_evidence) <= EXACT
    assert abs(jns.log_evidence_error - tns.log_evidence_error) <= EXACT
    assert abs(
        log_evidence_from_ins_samples(tns.samples_unit) - tns.log_evidence
    ) <= EXACT


def test_unit_hypercube_surface_equals_jax():
    rng = np.random.default_rng(13)
    jax_model, model = JaxModel(2), IntegrationTestModel(2)
    jax_model.set_rng(np.random.default_rng(1))
    model.set_rng(np.random.default_rng(1))
    u = rng.uniform(-0.1, 1.1, (300, 2))
    ours_u, theirs_u = numpy_array_to_live_points(u, model.names), jax_to_live_points(u, model.names)
    np.testing.assert_array_equal(model.in_unit_hypercube(ours_u), jax_model.in_unit_hypercube(theirs_u))
    np.testing.assert_array_equal(
        model.batch_evaluate_log_prior_unit_hypercube(ours_u),
        jax_model.batch_evaluate_log_prior_unit_hypercube(theirs_u),
    )
    np.testing.assert_array_equal(
        model.batch_evaluate_log_prior(ours_u, unit_hypercube=True),
        jax_model.batch_evaluate_log_prior(theirs_u, unit_hypercube=True),
    )
    # both through their float32 device hooks
    model.device = "cpu"
    np.testing.assert_allclose(
        model.batch_evaluate_log_likelihood(ours_u, unit_hypercube=True),
        jax_model.batch_evaluate_log_likelihood(theirs_u, unit_hypercube=True),
        rtol=1e-6,
    )
    back = model.to_unit_hypercube(model.from_unit_hypercube(ours_u))
    for n in model.names:
        np.testing.assert_allclose(back[n], u[:, model.names.index(n)], atol=1e-15)
    np.testing.assert_array_equal(
        model.sample_unit_hypercube(50)["x_0"], jax_model.sample_unit_hypercube(50)["x_0"]
    )

    class Uniform(UniformPriorMixin, Model):
        def __init__(self):
            self.names = ["x_0", "x_1"]
            self.bounds = {"x_0": [-10.0, 10.0], "x_1": [-10.0, 10.0]}

        def log_likelihood(self, x):
            return np.zeros(len(x))

    uniform = Uniform()
    x = model.from_unit_hypercube(ours_u)
    for n in model.names:
        np.testing.assert_array_equal(uniform.from_unit_hypercube(ours_u)[n], x[n])
        np.testing.assert_array_equal(uniform.to_unit_hypercube(x)[n], model.to_unit_hypercube(x)[n])
    np.testing.assert_array_equal(uniform.log_prior(x), model.log_prior(x))


# ----------------------------------------------------------------------
# Statistical level and whole runs on the CPU
# ----------------------------------------------------------------------
def test_ins_2d_gaussian(tmp_path):
    """The JAX package's ``test_ins_2d_gaussian`` settings
    (``tests/test_sampling_ins.py``), on the CPU: logZ within 5σ (σ at
    least 0.02) of the analytic value, posterior means within 0.3 of 0."""
    model = IntegrationTestModel(2)
    fs = FlowSampler(
        model,
        output=str(tmp_path),
        importance_nested_sampler=True,
        nlive=1000,
        min_samples=200,
        seed=1234,
        flow_config=FLOW_CONFIG,
        training_config=dict(max_epochs=50, patience=10, batch_size=500),
        draw_iid_live=False,
        plot=False,
        checkpointing=False,
        device="cpu",
    )
    logZ, samples = fs.run(plot=False, save=False)
    err = fs.logZ_error
    analytic = model.analytic_log_evidence
    assert np.isfinite(logZ)
    assert abs(logZ - analytic) < 5 * max(err, 0.02), (logZ, err, analytic)
    assert len(samples) == len(fs.ns.training_samples.samples)
    post = fs.posterior_samples
    assert len(post) > 100
    for n in model.names:
        assert abs(np.mean(post[n])) < 0.3


def test_ins_capped_iid_live(tmp_path):
    """A capped run that draws i.i.d. live points: three levels, one
    log_q column per proposal in both sample sets, normalised weights,
    and the threshold and evidence from the i.i.d. set."""
    fs = FlowSampler(
        IntegrationTestModel(2),
        output=str(tmp_path),
        importance_nested_sampler=True,
        nlive=200,
        min_samples=100,
        seed=42,
        max_iteration=3,
        flow_config=FLOW_CONFIG,
        training_config=dict(max_epochs=50, patience=10, batch_size=500),
        draw_iid_live=True,
        plot=False,
        checkpointing=False,
        device="cpu",
    )
    logZ, samples = fs.run(plot=False, save=False)
    ns = fs.ns
    assert ns.iteration == 3 and ns.proposal.flow.n_models == 3
    assert np.isfinite(logZ) and logZ == ns.iid_samples.state.log_evidence
    assert np.isclose(ns.proposal.weights_array.sum(), 1.0)
    for ordered in (ns.training_samples, ns.iid_samples):
        assert ordered.log_q.shape == (len(ordered.samples), 4)
        assert ordered.is_nested.all()
    assert len(samples) == len(ns.iid_samples.samples) == 800
    assert len(ns.training_samples.samples) == 800
    assert ns.update_log_q_time.total_seconds() > 0
    assert ns.proposal.flow.log_prob_all_time.total_seconds() > 0
    post = fs.posterior_samples
    assert len(post) and all(np.isfinite(post[n]).all() for n in ns.model.names)
    assert ns.history["n_removed"] and len(ns.history["logZ"]) == 3


#: a capped INS run that takes a second or two on the CPU
CAPPED_INS = dict(
    importance_nested_sampler=True,
    nlive=100,
    min_samples=50,
    seed=4,
    max_iteration=1,
    flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
    training_config=dict(max_epochs=5, patience=3, batch_size=100),
    device="cpu",
)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(checkpointing=True),
        dict(plot=True),
        dict(n_pool=2),
        dict(resume=True),
    ],
    ids=lambda k: next(iter(k)),
)
def test_ins_options_of_the_persistence_layer_run(tmp_path, kwargs):
    """The options that once raised now run: a checkpoint that resumes,
    the sampler's plots, a pool closed at the end of the run, and a
    resume that finds nothing and starts afresh."""
    options = dict(dict(checkpointing=False, plot=False), **kwargs)
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), **CAPPED_INS, **options)
    with _time_limit(120):
        fs.run(plot=False, save=False)
    resume_file = tmp_path / "nested_sampler_resume.pkl"
    assert resume_file.exists() == bool(options["checkpointing"])
    if options["checkpointing"]:
        resumed = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), **CAPPED_INS)
        assert resumed.ns.iteration == fs.ns.iteration and resumed.logZ == fs.logZ
    if options["plot"]:
        fs.ns.produce_plots()
        assert (tmp_path / "state.png").exists() and (tmp_path / "trace.png").exists()
    assert fs.ns.model.pool is None
    assert np.isfinite(fs.logZ)


@pytest.mark.parametrize("kwargs", [dict(plot=True), dict(save=True)])
def test_run_writes_plots_or_the_result_file(tmp_path, kwargs):
    """``run(plot=True)`` writes the INS plots (of a sampler made with
    ``plot=True``) and the posterior plot; ``run(save=True)`` the HDF5
    result file."""
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), checkpointing=False,
                     plot=kwargs.get("plot", False), **CAPPED_INS)
    fs.run(**dict(dict(plot=False, save=False), **kwargs))
    written = set(os.listdir(tmp_path))
    if kwargs.get("plot"):
        assert {"state.png", "trace.png", "likelihood_levels.png", "posterior_distribution.png"} <= written
        assert "result.hdf5" not in written
    else:
        assert "result.hdf5" in written and not any(f.endswith(".png") for f in written)


@pytest.mark.parametrize("entry", ["flowsampler", "proposal", "flowmodel"])
def test_entry_points_without_gpu_raise(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        if entry == "flowsampler":
            FlowSampler(IntegrationTestModel(2), output=str(tmp_path), importance_nested_sampler=True, nlive=100)
        elif entry == "proposal":
            ImportanceFlowProposal(IntegrationTestModel(2), output=str(tmp_path))
        else:
            ImportanceFlowModel(dict(n_inputs=2), output=str(tmp_path))


def test_draws_from_the_whole_meta_proposal_after_a_run(tmp_path):
    """After a capped run: the sample counts rebuilt from the stored
    samples, mixture draws (prior and every level) with their
    meta-proposal density, prior draws, and more nested samples."""
    fs = FlowSampler(
        IntegrationTestModel(2),
        output=str(tmp_path),
        importance_nested_sampler=True,
        nlive=200,
        min_samples=100,
        seed=7,
        max_iteration=2,
        flow_config=FLOW_CONFIG,
        training_config=dict(max_epochs=20, patience=10, batch_size=500),
        draw_iid_live=False,
        plot=False,
        checkpointing=False,
        device="cpu",
    )
    fs.run(plot=False, save=False)
    ns, proposal = fs.ns, fs.ns.proposal
    counts = dict(ns.sample_counts)
    ns.update_sample_counts()
    assert ns.sample_counts == counts == {-1: 200, 0: 200, 1: 200}
    ns.update_proposal_weights()
    np.testing.assert_allclose(proposal.weights_array, [1 / 3] * 3)
    for samples, log_q in (proposal.draw_from_flows(600), proposal.draw_from_prior(300)):
        x_prime, log_j = proposal.rescale(samples)
        log_Q, log_q_again = proposal.compute_log_Q(x_prime, log_j)
        assert log_q.shape == (len(samples), 3)
        np.testing.assert_allclose(log_q_again, log_q, atol=1e-9)
        np.testing.assert_allclose(samples["logQ"], log_Q, atol=1e-9)
        np.testing.assert_array_equal(samples["logW"], samples["logU"] - samples["logQ"])
    n_before = len(ns.training_samples.samples)
    ns.draw_more_nested_samples(100)
    assert len(ns.training_samples.samples) == n_before + 100
    assert ns.training_samples.is_nested.all()
    assert np.isfinite(ns.training_samples.state.log_evidence)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_update=50),
        dict(draw_constant=False),
        dict(reparameterisation=None),
        dict(reset_flow=False),
        dict(reset_flow=2),
        dict(threshold_method="quantile", threshold_kwargs=dict(q=0.6)),
        dict(stopping_criterion=["ratio", "ess"], tolerance=[0.0, 1e4], check_criteria="all"),
        dict(weighted_kl=True),
        dict(bootstrap=True),
        dict(replace_all=True),
        dict(train_final_flow=True),
    ],
    ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items())[:40],
)
def test_ins_options_run(tmp_path, kwargs):
    """Capped runs through the sampler's other options."""
    fs = FlowSampler(
        IntegrationTestModel(2),
        output=str(tmp_path),
        importance_nested_sampler=True,
        nlive=200,
        min_samples=100,
        seed=3,
        max_iteration=2,
        flow_config=FLOW_CONFIG,
        training_config=dict(max_epochs=20, patience=10, batch_size=500),
        plot=False,
        checkpointing=False,
        device="cpu",
        **kwargs,
    )
    logZ, samples = fs.run(plot=False, save=False)
    ns = fs.ns
    # the final flow is one more level, which no sample count weighs
    final_flow = kwargs.get("train_final_flow", False)
    weights = ns.proposal.weights_array
    assert ns.iteration == 2 and ns.proposal.flow.n_models == 2 + final_flow
    assert np.isfinite(logZ) and np.isclose(weights[: 3].sum(), 1.0)
    assert np.isnan(weights[3:]).all() and len(weights) == 3 + final_flow
    assert set(ns.criterion) == set(ns.stopping_criteria)
    added = ns.history["n_removed"] if kwargs.get("draw_constant") is False else [200, 200]
    assert len(samples) == 200 + sum(added)
    # every sample, in the model space; the store in the unit hypercube
    for n in ns.model.names:
        lo, hi = ns.model.bounds[n]
        assert ((samples[n] >= lo) & (samples[n] <= hi)).all()
        assert ((ns.samples_unit[n] >= 0) & (ns.samples_unit[n] <= 1)).all()
    if kwargs.get("bootstrap"):
        assert np.isfinite(ns.bootstrap_log_evidence) and np.isfinite(ns.bootstrap_log_evidence_error)
