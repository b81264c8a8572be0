"""The importance nested sampler's weighted training, replace_all, final
redraw, bootstrap and final flow in the port against the JAX package's.

- Module level: the weighted loss and its gradients through converted
  weights (atol 1e-5 + rtol 1e-5); the KL divergence between levels
  through converted levels (1e-5).
- Trajectory level: the training weights of ``weighted_kl``, the
  optimised meta-proposal weights, ``replace_all``'s bookkeeping, the
  final redraw and the bootstrap, both packages fed the same numpy-made
  draws (1e-12; the optimised weights 1e-8).
- Statistical level: whole runs of both packages on the CPU against the
  analytic evidence (3σ) and each other (3σ).
"""

import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu import config as jax_config
from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu.flowmodel.base import _combine_params, _partition_params
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.livepoint import numpy_array_to_live_points as jax_to_live_points
from nessai_tpu.model import Model as JaxBaseModel
from nessai_tpu.proposal.importance import ImportanceFlowProposal as JaxImportanceFlowProposal
from nessai_tpu.samplers.importancesampler import ImportanceNestedSampler as JaxINS
from nessai_tpu.samplers.importancesampler import OrderedSamples as JaxOrderedSamples
from nessai_tpu.utils.optimise import optimise_meta_proposal_weights as jax_optimise
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch import config
from nessai_tpu_torch.flowmodel import FlowModel
from nessai_tpu_torch.flowmodel.base import _clip_by_global_norm
from nessai_tpu_torch.flows import params_from_jax, params_to_jax
from nessai_tpu_torch.flows.convert import levels_from_jax
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.proposal import ImportanceFlowProposal
from nessai_tpu_torch.samplers import ImportanceNestedSampler, NestedSampler
from nessai_tpu_torch.samplers.importancesampler import OrderedSamples
from nessai_tpu_torch.utils.optimise import optimise_meta_proposal_weights
from nessai_tpu_torch.utils.testing import GaussianMixture, IntegrationTestModel, time_limit

#: module-level tolerance: float32 flows on both sides
ATOL = RTOL = 1e-5
#: trajectory-level tolerance of host float64 bookkeeping
EXACT = 1e-12
#: the optimised weights: SLSQP on the same float64 inputs
OPTIMISE_TOL = 1e-8
FLOW_CONFIG = dict(n_blocks=2, n_neurons=16, n_layers=1)
NAMES = ["x_0", "x_1"]


@pytest.fixture(autouse=True)
def _highest_precision_and_clean_fields():
    torch.set_float32_matmul_precision("highest")
    yield
    config.livepoints.reset()
    jax_config.livepoints.reset()


class JaxGaussianMixture(JaxBaseModel):
    """The model of ``examples/importance_nested_sampler/
    ins_gaussian_mixture.py``, as written there."""

    def __init__(self, dims=2):
        self.names = [f"x_{d}" for d in range(dims)]
        self.bounds = {n: [-10.0, 10.0] for n in self.names}

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        x = self.unstructured_view(x)
        a = -0.5 * np.sum((x - 4) ** 2, axis=-1)
        b = -0.5 * np.sum((x + 4) ** 2, axis=-1)
        norm_const = x.shape[-1] * 0.5 * np.log(2 * np.pi)
        return np.logaddexp(a, b) - np.log(2) - norm_const

    def to_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = (x[n] - lo) / (hi - lo)
        return x_out

    def from_unit_hypercube(self, x):
        x_out = x.copy()
        for n in self.names:
            lo, hi = self.bounds[n]
            x_out[n] = x[n] * (hi - lo) + lo
        return x_out


def _perturbed(params, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + rng.normal(0.0, scale, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, params),
    )


def _in_bounds(samples, model):
    return all(
        ((samples[n] >= model.bounds[n][0]) & (samples[n] <= model.bounds[n][1])).all() for n in model.names
    )


# ----------------------------------------------------------------------
# Weighted flow training
# ----------------------------------------------------------------------
def _flow_pair(tmp_path, seed=0):
    cfg = dict(FLOW_CONFIG, n_inputs=2)
    jfm = JaxFlowModel(cfg, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed))
    jfm.initialise()
    p = _perturbed(jfm.params, seed + 1)
    jfm.params = jax.tree.map(jnp.asarray, p)
    jfm.reset_optimiser()
    tfm = FlowModel(cfg, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed), device="cpu")
    tfm.initialise()
    params_from_jax(tfm.flow, p)
    tfm.reset_optimiser()
    return jfm, tfm


def _batch(n=256, seed=3):
    rng = np.random.default_rng(seed)
    x = (1.0 + 2.0 * rng.standard_normal((n, 2))).astype(np.float32)
    w = rng.exponential(1.0, n).astype(np.float32)
    return x, w


def test_weighted_loss_and_gradients_match_jax(tmp_path):
    """The JAX package's weighted loss (its training epoch on one batch)
    and its gradients against the port's, through converted weights."""
    jfm, tfm = _flow_pair(tmp_path)
    x, w = _batch()
    flow = jfm.flow

    diff, aux = _partition_params(jfm.params)

    def jax_loss(diff):
        log_p = flow.log_prob(_combine_params(diff, aux), jnp.asarray(x), None)
        return -jnp.sum(jnp.asarray(w) * log_p) / jnp.maximum(jnp.sum(jnp.asarray(w)), 1e-12)

    j_loss, j_grads = jax.value_and_grad(jax_loss)(diff)
    train_epoch, _ = jfm._epoch_fns(False, False)
    _, _, j_epoch_loss = train_epoch(
        jfm.params, jfm.opt_state, {"x": jnp.asarray(x)[None], "w": jnp.asarray(w)[None]}, jax.random.PRNGKey(0)
    )
    # the epoch's loss is its loss_fn on the batch: the formula above
    np.testing.assert_allclose(float(j_epoch_loss), float(j_loss), rtol=RTOL)

    x_t, w_t = torch.as_tensor(x), torch.as_tensor(w)
    loss = tfm._loss(x_t, w_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL, rtol=RTOL)
    grads = copy.deepcopy(tfm.flow)
    for p, source in zip(grads.parameters(), tfm.flow.parameters()):
        # no gradient: a parameter the loss does not reach
        p.data = torch.zeros_like(p) if source.grad is None else source.grad.clone()
    ours = jax.tree.leaves(params_to_jax(grads))
    assert len(ours) == len(j_grads)
    n_float = 0
    for a, b in zip(ours, j_grads):
        if b is not None:
            n_float += 1
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)
    assert n_float > 0
    # and one optimiser step from the same weights gives the same loss
    tfm.flow.zero_grad(set_to_none=True)
    step_loss = tfm._train_step(x_t, w_t)
    np.testing.assert_allclose(step_loss.item(), float(j_epoch_loss), atol=ATOL, rtol=RTOL)


def test_unweighted_step_is_unchanged(tmp_path):
    """Without weights the step's loss is ``-log_prob(x).mean()`` bit for
    bit, and the step moves the weights as that loss's AdamW step does."""
    _, tfm = _flow_pair(tmp_path)
    x = torch.as_tensor(_batch()[0])
    twin = copy.deepcopy(tfm)
    twin.reset_optimiser()
    # the step as the port wrote it before weights existed
    twin.optimiser.zero_grad(set_to_none=True)
    expected = -twin.flow.log_prob(x).mean()
    expected.backward()
    _clip_by_global_norm(twin._trainable(), twin.training_config.clip_grad_norm)
    twin.optimiser.step()
    loss = tfm._train_step(x)
    assert torch.equal(loss, expected.detach())
    for a, b in zip(tfm.flow.state_dict().values(), twin.flow.state_dict().values()):
        assert torch.equal(a, b)


def test_weighted_training_uses_and_splits_the_weights(tmp_path):
    """``prep_data`` shuffles the weights with the samples and splits
    them with the same permutation; the validation metric is the
    weighted loss of the validation rows."""
    _, tfm = _flow_pair(tmp_path)
    x, w = _batch(100)
    twin = copy.deepcopy(tfm)
    ours = tfm.prep_data(x, 0.2, batch_size=30, weights=w)
    plain = twin.prep_data(x, 0.2, batch_size=30)
    batches, val, w_batches, w_val = ours
    assert plain[2] is None and plain[3] is None
    for a, b in zip(batches, plain[0]):
        assert torch.equal(a, b)
    assert torch.equal(val, plain[1])
    assert [len(b) for b in w_batches] == [len(b) for b in batches] == [30, 30, 20]
    # the weights travel with their rows
    lookup = {tuple(row): weight for row, weight in zip(x.tolist(), w.tolist())}
    for rows, weights in list(zip(batches, w_batches)) + [(val, w_val)]:
        for row, weight in zip(rows.tolist(), weights.tolist()):
            assert lookup[tuple(row)] == weight
    with pytest.raises(ValueError, match="non-finite"):
        tfm.prep_data(x, 0.2, weights=np.where(np.arange(100) == 3, np.nan, w))
    history = tfm.train(x, weights=w, max_epochs=2, save=False)
    assert len(history["loss"]) == 2 and np.isfinite(history["val_loss"]).all()


# ----------------------------------------------------------------------
# weighted_kl and the level helpers of the proposal
# ----------------------------------------------------------------------
def _proposal_pair(tmp_path, seed=0, weighted_kl=True):
    jax_model, model = JaxModel(2), IntegrationTestModel(2)
    for m in (jax_model, model):
        m.set_rng(np.random.default_rng(seed))
    jp = JaxImportanceFlowProposal(
        jax_model, output=str(tmp_path / "jax"), flow_config=FLOW_CONFIG,
        weighted_kl=weighted_kl, rng=np.random.default_rng(seed),
    )
    tp = ImportanceFlowProposal(
        model, output=str(tmp_path / "torch"), flow_config=FLOW_CONFIG,
        weighted_kl=weighted_kl, rng=np.random.default_rng(seed), device="cpu",
    )
    return jp, tp


def _captured_training_weights(proposal, samples, weights):
    """The weights that ``proposal.train`` passes to its flow (training
    and the new level stubbed out)."""
    seen = []
    proposal.flow.add_new_flow = lambda **kwargs: None
    proposal.flow.train = lambda x, weights=None, **kwargs: seen.append(weights)
    proposal.train(samples, weights=weights)
    return seen[0]


def _weighted_samples(to_live_points, n=400, seed=4):
    rng = np.random.default_rng(seed)
    s = to_live_points(rng.uniform(0.05, 0.95, (n, 2)), NAMES)
    s["logW"] = rng.normal(-3.0, 4.0, n)
    return s


@pytest.mark.parametrize("source", ["logW", "passed", "passed_negative", "unweighted"])
def test_weighted_kl_weights_equal_jax(tmp_path, source):
    """``weighted_kl`` derives the training weights from logW as the JAX
    package does, and weights passed in are normalised the same way."""
    ImportanceNestedSampler.add_fields()
    JaxINS.add_fields()
    jp, tp = _proposal_pair(tmp_path, weighted_kl=source != "unweighted")
    weights = None
    if source.startswith("passed"):
        weights = np.random.default_rng(5).exponential(2.0, 400) * (-1 if source == "passed_negative" else 1)
    ours = _captured_training_weights(tp, _weighted_samples(numpy_array_to_live_points), weights)
    theirs = _captured_training_weights(jp, _weighted_samples(jax_to_live_points), weights)
    assert tp.level_count == jp.level_count == 0 and np.isnan(tp.weights[0])
    if source == "unweighted":
        assert ours is None and theirs is None
        return
    np.testing.assert_allclose(ours, theirs, atol=EXACT, rtol=0)
    assert abs(ours.sum() - 1.0) <= EXACT and (ours > 0).all()


@pytest.mark.parametrize(
    "weights, message",
    [
        (np.where(np.arange(400) == 7, np.nan, 1.0), "NaN"),
        # sums to zero: the normalised weights are +-inf
        (np.where(np.arange(400) % 2 == 0, 1.0, -1.0), "Inf"),
    ],
    ids=["nan", "inf"],
)
def test_weighted_kl_errors_equal_jax(tmp_path, weights, message):
    ImportanceNestedSampler.add_fields()
    JaxINS.add_fields()
    jp, tp = _proposal_pair(tmp_path)
    errors = []
    for proposal, to_lp in ((tp, numpy_array_to_live_points), (jp, jax_to_live_points)):
        with np.errstate(divide="ignore", invalid="ignore"):
            with pytest.raises(ValueError, match=f"Weights contain {message}") as info:
                _captured_training_weights(proposal, _weighted_samples(to_lp), weights)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_compute_kl_between_proposals_matches_jax(tmp_path):
    """Through converted levels: the newest against the one before, a
    level against the prior (no Jacobian for the prior), and an equal
    pair, which raises."""
    ImportanceNestedSampler.add_fields()
    JaxINS.add_fields()
    jp, tp = _proposal_pair(tmp_path, weighted_kl=False)
    jp.flow.initialise()
    levels = [_perturbed(jp.flow.params, 10 + i) for i in range(3)]
    jp.flow.params_list = [jax.tree.map(jnp.asarray, p) for p in levels]
    jp.flow._stacked = None
    tp.flow.initialise()
    levels_from_jax(tp.flow, levels)
    u = np.random.default_rng(6).uniform(0.02, 0.98, (1000, 2))
    x_t, x_j = numpy_array_to_live_points(u, NAMES), jax_to_live_points(u, NAMES)
    for p_it, q_it in ((None, None), (2, -1), (-1, 0), (1, 0)):
        ours = tp.compute_kl_between_proposals(x_t, p_it, q_it)
        theirs = jp.compute_kl_between_proposals(x_j, p_it, q_it)
        np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL)
    for p_it, q_it in ((1, 1), (-2, 0)):
        for proposal, x in ((tp, x_t), (jp, x_j)):
            with pytest.raises(ValueError):
                proposal.compute_kl_between_proposals(x, p_it, q_it)
    with pytest.raises(ValueError, match="No proposal"):
        tp.get_proposal_log_prob(3)
    np.testing.assert_array_equal(tp.get_proposal_log_prob(-1)(u), np.zeros(1000))


# ----------------------------------------------------------------------
# replace_all and the optimised weights
# ----------------------------------------------------------------------
def test_remove_samples_with_replace_all_equals_jax():
    ImportanceNestedSampler.add_fields()
    JaxINS.add_fields()
    rng = np.random.default_rng(9)
    u, log_l = rng.uniform(size=(300, 2)), rng.normal(size=300)
    u_new, log_l_new = rng.uniform(size=(50, 2)), rng.normal(size=50)
    stores = []
    for cls, to_lp in ((OrderedSamples, numpy_array_to_live_points), (JaxOrderedSamples, jax_to_live_points)):
        store = cls(replace_all=True)
        s = to_lp(u, NAMES)
        s["logL"] = log_l
        store.add_initial_samples(s, np.zeros((300, 1)))
        store.update_log_likelihood_threshold(np.quantile(log_l, 0.3))
        store.add_to_nested_samples(np.arange(10))
        # every live point moves, not only those below the threshold
        assert store.remove_samples() == 290
        assert store.live_points is None and store.is_nested.all()
        new = to_lp(u_new, NAMES)
        new["logL"] = log_l_new
        store.add_samples(new, np.zeros((50, 1)))
        stores.append(store)
    a, b = stores
    for field in a.samples.dtype.names:
        np.testing.assert_array_equal(a.samples[field], b.samples[field])
    np.testing.assert_array_equal(a.is_nested, b.is_nested)
    assert len(a.live_points) == 50


def _optimise_inputs(seed=12, n=500, k=4):
    rng = np.random.default_rng(seed)
    log_q = np.concatenate([np.zeros((n, 1)), rng.normal(0.5, 1.0, (n, k - 1))], axis=1)
    log_l = rng.normal(-3.0, 1.0, n)
    return log_l, log_q


@pytest.mark.parametrize("form", ["plain", "positional_weights", "structured"])
def test_optimise_meta_proposal_weights_equals_jax(form):
    log_l, log_q = _optimise_inputs()
    initial = np.array([0.4, 0.3, 0.2, 0.1])
    if form == "plain":
        args, kwargs = (log_l, log_q), {}
    elif form == "positional_weights":
        args, kwargs = (log_l, log_q, initial), {}
    else:
        s = np.zeros(len(log_l), dtype=[("logL", "f8"), ("it", "i4")])
        s["logL"] = log_l
        s["it"] = np.repeat(np.arange(-1, 3), [200, 150, 100, 50])
        args, kwargs = (s, log_q), dict(options={"maxiter": 50})
    ours = optimise_meta_proposal_weights(*args, **kwargs)
    theirs = jax_optimise(*args, **kwargs)
    assert ours.shape == (4,) and abs(ours.sum() - 1.0) <= EXACT
    np.testing.assert_allclose(ours, theirs, atol=OPTIMISE_TOL, rtol=0)


# ----------------------------------------------------------------------
# The final redraw and the bootstrap on the same draws
# ----------------------------------------------------------------------
def _host_samplers(tmp_path, seed=8, **kwargs):
    """Both samplers on the Gaussian mixture (a host likelihood in
    float64 in both packages), with one numpy-made store of 1000 prior
    samples and 600 samples of one level."""
    kwargs = dict(nlive=600, min_samples=100, seed=seed, draw_iid_live=False, **kwargs)
    jns = JaxINS(JaxGaussianMixture(2), output=str(tmp_path / "jax"), checkpointing=False, plot=False, **kwargs)
    tns = ImportanceNestedSampler(GaussianMixture(2), output=str(tmp_path / "torch"), checkpointing=False, plot=False,
                                  device="cpu", **kwargs)
    rng = np.random.default_rng(21)
    u0, u1 = rng.uniform(size=(1000, 2)), 0.5 + 0.4 * (rng.uniform(size=(600, 2)) - 0.5)
    col = rng.normal(0.0, 1.0, (1600, 1))
    log_q = np.concatenate([np.zeros((1600, 1)), col], axis=1)
    for ns, to_lp in ((jns, jax_to_live_points), (tns, numpy_array_to_live_points)):
        ns.initialise_history()
        ns.sample_counts = {-1: 1000, 0: 600}
        ns.proposal.level_count = 0
        ns.proposal.update_proposal_weights({-1: 0.625, 0: 0.375})
        s = to_lp(np.concatenate([u0, u1]), NAMES)
        s["logL"] = ns.model.batch_evaluate_log_likelihood(s, unit_hypercube=True)
        s["it"] = np.repeat([-1, 0], [1000, 600])
        s["logU"] = 0.0
        s["logQ"] = ns.proposal.compute_meta_proposal_from_log_q(log_q)
        s["logW"] = -s["logQ"]
        ns.training_samples.add_initial_samples(s, log_q)
        ns.training_samples.finalise()
        ns.finalised = True
    return jns, tns


def _patch_draws(ns, to_lp, seed=30):
    """Replace ``draw_from_flows`` with draws from a numpy generator: the
    same sequence of batches in both packages. Returns the calls."""
    rng = np.random.default_rng(seed)
    calls = []

    def draw_from_flows(n, weights=None, counts=None):
        calls.append((n, None if weights is None else np.array(weights), None if counts is None else np.array(counts)))
        # around the mode at (4, 4): weights of a moderate spread
        u = 0.7 + 0.05 * (rng.uniform(size=(n, 2)) - 0.5)
        s = to_lp(u, NAMES)
        s["logQ"] = rng.normal(1.0, 0.5, n)
        s["logU"] = 0.0
        s["logW"] = -s["logQ"]
        return s, np.zeros((n, 2))

    ns.proposal.draw_from_flows = draw_from_flows
    return calls


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_post=1500),
        dict(n_draw=2500),
        dict(n_post=10**6, max_samples_ratio=1.5, max_batch_size=1000),
        dict(n_post=10**6, max_its=3, max_batch_size=700, max_samples_ratio=None),
        dict(),
        dict(n_post=800, optimise_weights=True),
        dict(n_post=800, optimise_weights=True, optimisation_method="evidence"),
    ],
    ids=["n_post", "n_draw", "max_samples_ratio", "max_its", "default", "optimise_kl", "optimise_evidence"],
)
def test_draw_final_samples_equals_jax(tmp_path, caplog, kwargs):
    """The same redraw batches through both packages: the stop rule, the
    final state, logZ and its error, the posterior weights."""
    jns, tns = _host_samplers(tmp_path)
    calls = [_patch_draws(jns, jax_to_live_points), _patch_draws(tns, numpy_array_to_live_points)]
    with caplog.at_level(logging.WARNING):
        out = [ns.draw_final_samples(**kwargs) for ns in (jns, tns)]
    assert len(calls[0]) == len(calls[1]) >= 1
    for (n_j, w_j, _), (n_t, w_t, _) in zip(*calls):
        assert n_j == n_t
        np.testing.assert_allclose(w_t, w_j, atol=OPTIMISE_TOL, rtol=0)
    for field in out[0].dtype.names:
        np.testing.assert_allclose(out[1][field], out[0][field], atol=EXACT, rtol=0)
    for attr in ("final_log_evidence", "final_log_evidence_error"):
        assert abs(getattr(jns, attr) - getattr(tns, attr)) <= EXACT, attr
    for attr in ("log_evidence", "log_evidence_error", "effective_n_posterior_samples"):
        assert abs(getattr(jns.final_state, attr) - getattr(tns.final_state, attr)) <= EXACT, attr
    np.testing.assert_allclose(tns.final_log_posterior_weights, jns.final_log_posterior_weights, atol=EXACT, rtol=0)
    np.testing.assert_array_equal(tns.final_log_w, tns.final_samples_unit["logL"] + tns.final_samples_unit["logW"])
    n = len(out[1])
    if "n_draw" in kwargs:
        assert n == kwargs["n_draw"]
    elif "max_its" in kwargs:
        assert n == 2100 and sum("Failed to reach target ESS" in r.message for r in caplog.records) == 2
    elif "max_samples_ratio" in kwargs:
        assert n == 3000 and sum("maximum number of redraw" in r.message for r in caplog.records) == 2
    else:
        target = kwargs.get("n_post", int(tns.state.effective_n_posterior_samples))
        assert tns.final_state.effective_n_posterior_samples >= target
    # the redrawn samples give the posterior, in the model space
    model = tns.model
    assert _in_bounds(tns.final_samples, model)
    for name in NAMES:
        np.testing.assert_array_equal(tns.final_samples[name], model.from_unit_hypercube(tns.final_samples_unit)[name])
    post = tns.draw_posterior_samples()
    assert len(post) and _in_bounds(post, model)


def test_draw_final_samples_validation_equals_jax(tmp_path):
    jns, tns = _host_samplers(tmp_path)
    for ns in (jns, tns):
        with pytest.raises(RuntimeError, match="at most one"):
            ns.draw_final_samples(n_post=10, n_draw=10)
        with pytest.raises(ValueError):
            ns.draw_final_samples(n_post=10, optimise_weights=True, optimisation_method="bad")
        assert ns.final_state is None and ns.final_log_evidence is None
        assert ns.final_log_evidence_error is None and ns.final_samples is None
        assert ns.final_log_posterior_weights is None


def test_adjust_final_samples_equals_jax(tmp_path):
    """The bootstrap: the same multinomial counts from the run's rng, the
    same draws, the same bootstrap logZ and error."""
    jns, tns = _host_samplers(tmp_path)
    calls = [_patch_draws(jns, jax_to_live_points), _patch_draws(tns, numpy_array_to_live_points)]
    for ns in (jns, tns):
        assert ns.bootstrap_log_evidence is None and ns.bootstrap_log_evidence_error is None
        ns.rng = np.random.default_rng(77)
        ns.adjust_final_samples(n_batches=4)
    assert len(calls[1]) == 4
    for (n_j, _, c_j), (n_t, _, c_t) in zip(*calls):
        assert n_j == n_t == 1600
        np.testing.assert_array_equal(c_t, c_j)
        assert c_t.sum() == 1600 and len(c_t) == 2
    assert abs(jns.bootstrap_log_evidence - tns.bootstrap_log_evidence) <= EXACT
    assert abs(jns.bootstrap_log_evidence_error - tns.bootstrap_log_evidence_error) <= EXACT
    assert np.isfinite(tns.bootstrap_log_evidence_error) and tns.bootstrap_log_evidence_error > 0


def test_nan_level_weight_stops_the_draws_before_drawing(tmp_path):
    """A level without a weight (what the final flow leaves): the
    port's draws raise a RuntimeError that names the final flow, before
    any draw."""
    ImportanceNestedSampler.add_fields()
    _, tp = _proposal_pair(tmp_path, weighted_kl=False)
    tp.flow.initialise()
    tp.level_count = 0
    tp._weights[0] = np.nan
    state = tp.rng.bit_generator.state
    with pytest.raises(RuntimeError, match="train_final_flow"):
        tp.draw_from_flows(100)
    with pytest.raises(RuntimeError, match="train_final_flow"):
        tp.draw_from_flows(100, counts=[50, 50])
    with pytest.raises(RuntimeError, match="Some weights are not set!.*train_final_flow"):
        tp.compute_log_Q(np.zeros((3, 2)), np.zeros(3))
    assert tp.rng.bit_generator.state == state


# ----------------------------------------------------------------------
# Whole runs on the CPU
# ----------------------------------------------------------------------
def _capped_kwargs(**kwargs):
    return dict(
        importance_nested_sampler=True,
        nlive=100,
        min_samples=50,
        seed=5,
        max_iteration=2,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
        training_config=dict(max_epochs=5, patience=3, batch_size=100),
        **kwargs,
    )


@pytest.mark.parametrize("follow", ["redraw", "bootstrap"])
def test_final_flow_then_redraw_or_bootstrap_fails_in_both(tmp_path, follow):
    """The final flow leaves its level without a weight in both packages,
    so a redraw or a bootstrap after it fails: the JAX package in numpy
    or in its meta-proposal, the port with its own RuntimeError."""
    options = dict(train_final_flow=True, bootstrap=follow == "bootstrap")
    run = dict(redraw_samples=follow == "redraw", n_posterior_samples=100)
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), device="cpu", plot=False,
                     checkpointing=False, **_capped_kwargs(**options))
    with pytest.raises(RuntimeError, match="train_final_flow"):
        fs.run(plot=False, save=False, **run)
    assert np.isnan(fs.ns.proposal.weights[fs.ns.proposal.level_count])
    assert fs.ns.proposal.flow.n_models == fs.ns.iteration + 1
    with jax.default_device(jax.devices("cpu")[0]):
        jfs = JaxFlowSampler(
            JaxModel(2), output=str(tmp_path / "jax"), resume=False, plot=False, checkpointing=False,
            **_capped_kwargs(**options),
        )
        with pytest.raises((ValueError, RuntimeError)):
            jfs.run(plot=False, save=False, **run)


def test_capped_run_returns_model_space_samples_and_final_samples(tmp_path):
    """The run returns every sample in the model space, as the JAX
    package does: ``fs.nested_samples`` and the sampler's ``samples``,
    ``nested_samples`` and ``live_points`` map the unit-hypercube
    samples through the model; the redrawn samples likewise."""
    model = IntegrationTestModel(2)
    fs = FlowSampler(model, output=str(tmp_path), device="cpu", plot=False, checkpointing=False, **_capped_kwargs())
    logZ, samples = fs.run(plot=False, save=False, redraw_samples=True, n_posterior_samples=150,
                           compute_initial_posterior=True)
    ns = fs.ns
    assert samples is fs.nested_samples and len(samples) == len(ns.samples_unit) == 300
    expected = model.from_unit_hypercube(ns.samples_unit)
    for name in NAMES:
        np.testing.assert_array_equal(samples[name], expected[name])
        np.testing.assert_array_equal(ns.samples[name], expected[name])
        np.testing.assert_array_equal(ns.nested_samples[name], expected[name])
    assert _in_bounds(samples, model) and samples["x_0"].min() < -1.0 and samples["x_0"].max() > 1.0
    assert ((ns.samples_unit["x_0"] >= 0) & (ns.samples_unit["x_0"] <= 1)).all()
    assert ns.live_points is None
    with pytest.raises(RuntimeError, match="Cannot set live points"):
        ns.live_points = samples
    # the redraw: logZ and its error are the final estimate's, the
    # sampler's stays in initial_logZ
    assert logZ == fs.logZ == ns.final_log_evidence and fs.logZ_error == ns.final_log_evidence_error
    assert fs.initial_logZ == ns.log_evidence and fs.initial_logZ_error == ns.log_evidence_error
    assert ns.final_state.effective_n_posterior_samples >= 150 or len(ns.final_samples_unit) > len(ns.samples_unit)
    final = model.from_unit_hypercube(ns.final_samples_unit)
    for name in NAMES:
        np.testing.assert_array_equal(ns.final_samples[name], final[name])
    assert _in_bounds(ns.final_samples, model)
    assert _in_bounds(fs.posterior_samples, model) and _in_bounds(fs.initial_posterior_samples, model)
    assert ns.draw_final_samples_time.total_seconds() > 0


def test_ins_whole_runs_agree_with_jax(tmp_path):
    """Both packages' INS on the 2-D Gaussian at small settings: each
    within 3σ of the analytic evidence and the two within 3σ of each
    other."""
    kwargs = dict(
        importance_nested_sampler=True,
        nlive=1000,
        min_samples=200,
        seed=1234,
        flow_config=FLOW_CONFIG,
        training_config=dict(max_epochs=50, patience=10, batch_size=500),
        draw_iid_live=False,
    )
    model = IntegrationTestModel(2)
    fs = FlowSampler(model, output=str(tmp_path / "torch"), device="cpu", plot=False, checkpointing=False, **kwargs)
    t_logz, _ = fs.run(plot=False, save=False)
    t_err = fs.logZ_error
    with jax.default_device(jax.devices("cpu")[0]):
        jfs = JaxFlowSampler(JaxModel(2), output=str(tmp_path / "jax"), resume=False, plot=False,
                             checkpointing=False, **kwargs)
        j_logz, j_samples = jfs.run(plot=False, save=False)
    j_err = jfs.logZ_error
    analytic = model.analytic_log_evidence
    assert abs(t_logz - analytic) < 3 * t_err, (t_logz, t_err)
    assert abs(j_logz - analytic) < 3 * j_err, (j_logz, j_err)
    assert abs(t_logz - j_logz) < 3 * np.hypot(t_err, j_err)
    assert _in_bounds(j_samples, model) and _in_bounds(fs.nested_samples, model)


# ----------------------------------------------------------------------
# The standard sampler's reference options
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "option, item",
    [
        (dict(stopping=0.5), "6"),
        (dict(stopping_criterion="ratio"), "6"),
        (dict(max_iteration=100), "6"),
        (dict(reset_flow=4), "6"),
        (dict(training_frequency=100), "6"),
        (dict(cooldown=50), "6"),
        (dict(maximum_uninformed=500), "6"),
        (dict(shrinkage_expectation="t"), "6"),
        (dict(simulated_evidence_error=False), "6"),
        (dict(flow_class="GWFlowProposal"), "6"),
        (dict(drawsize=100), "6"),
    ],
    ids=lambda v: next(iter(v)) if isinstance(v, dict) else v,
)
def test_standard_sampler_reference_options_raise_and_name_the_item(tmp_path, option, item):
    """These options raised naming ROADMAP item 6 until the sampler took
    them: no option is fixed by any item any more, and each is held by
    the sampler (an unknown flow class raises the JAX package's
    ``ValueError``)."""
    from nessai_tpu_torch.samplers import nestedsampler

    assert not hasattr(nestedsampler, "FIXED_OPTIONS")
    name = next(iter(option))
    if name == "flow_class":
        with pytest.raises(ValueError, match="Unknown flow class"):
            FlowSampler(IntegrationTestModel(2), output=str(tmp_path), nlive=50, device="cpu", **option)
        return
    ns = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), nlive=50, device="cpu", **option).ns
    held = {
        "stopping": ns.tolerance == 0.5,
        "stopping_criterion": type(ns.stopping_criterion).__name__ == "Ratio",
        "max_iteration": ns.max_iteration == 100,
        "reset_flow": ns.reset_weights == ns.reset_permutations == 4.0,
        "training_frequency": ns.training_frequency == 100,
        "cooldown": ns.cooldown == 50,
        "maximum_uninformed": ns.maximum_uninformed == 500,
        "shrinkage_expectation": ns.state.expectation == "t",
        "simulated_evidence_error": ns.simulated_evidence_error is False,
        "drawsize": ns.flow_proposal.drawsize == 100,
    }
    assert held[name]


#: a standard run that takes a few seconds on the CPU
SMALL_STANDARD = dict(
    nlive=50,
    seed=6,
    flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
    training_config=dict(max_epochs=5, patience=3),
    device="cpu",
)


class _SerialPool:
    """A pool with ``map`` that runs in this process."""

    _processes = 1

    def __init__(self):
        self.calls = 0
        self.closed = False

    def map(self, func, iterable):
        self.calls += 1
        return [func(x) for x in iterable]

    def close(self):
        self.closed = True

    def join(self):
        pass


@pytest.mark.parametrize(
    "option",
    [dict(checkpointing=True), dict(plot=True), dict(n_pool=2), dict(pool="serial"), dict(close_pool=True)],
    ids=lambda v: next(iter(v)),
)
def test_standard_sampler_takes_the_persistence_options(tmp_path, option):
    """The standard sampler's options of checkpoints, plots and the pool
    run: a final checkpoint and weight files, the state plot, a pool the
    host likelihood goes through, closed by the sampler at the end with
    ``close_pool``."""
    from nessai_tpu_torch.utils.multiprocessing import initialise_pool_variables

    model = IntegrationTestModel(2)
    model.torch_log_likelihood = None
    pool = None
    if option.get("pool") == "serial":
        pool = _SerialPool()
        initialise_pool_variables(model)
        option = dict(pool=pool)
    options = dict(dict(checkpointing=False, plot=False), **option)
    if "close_pool" in options:
        # the sampler's own option (FlowSampler takes close_pool itself)
        ns = NestedSampler(model, output=str(tmp_path), n_pool=1, **SMALL_STANDARD, **options)
        with time_limit(120):
            ns.nested_sampling_loop()
        assert ns.model.pool is None and np.isfinite(ns.log_evidence)
        return
    fs = FlowSampler(model, output=str(tmp_path), close_pool=False, **SMALL_STANDARD, **options)
    with time_limit(120):
        fs.run(plot=False, save=False)
    written = set(os.listdir(tmp_path))
    assert ("nested_sampler_resume.pkl" in written) == options["checkpointing"]
    assert ("model.pt" in os.listdir(tmp_path / "proposal")) == options["checkpointing"]
    assert ("state.png" in written) == options["plot"]
    if pool is not None:
        assert pool.calls > 0 and fs.ns.model.pool is pool
    if "n_pool" in options:
        assert fs.ns.model.n_pool == 2 and fs.ns.model.pool is not None
        fs.ns.model.close_pool()
    assert np.isfinite(fs.logZ)


@pytest.mark.parametrize(
    "options, stack",
    [
        (dict(reparameterisations=None), {"scaleandshift_x_0_x_1": "ScaleAndShift"}),
        (dict(reparameterisations="default"), {"rescaletobounds_x_0_x_1": "RescaleToBounds"}),
        (dict(reparameterisations={"x_0": "default"}),
         {"rescaletobounds_x_0": "RescaleToBounds", "scaleandshift_x_1": "ScaleAndShift"}),
        (dict(reparameterisations={"x_0": {"reparameterisation": "inversion-duplicate"}}),
         {"rescaletobounds_x_0": "RescaleToBounds", "scaleandshift_x_1": "ScaleAndShift"}),
        (dict(reparameterisations={"x_.*": "logit"}), {"rescaletobounds_x_0_x_1": "RescaleToBounds"}),
        (dict(reparameterisations={"angle": {"parameters": ["x_1"], "scale": None}}),
         {"angle_x_1": "Angle", "scaleandshift_x_0": "ScaleAndShift"}),
        (dict(reparameterisations={"x_0": "offset"}, fallback_reparameterisation=None),
         {"rescaletobounds_x_0": "RescaleToBounds", "identityreparameterisation_x_1": "IdentityReparameterisation"}),
        (dict(reparameterisations={"x_0": "default", "x_1": "zscore"}, reverse_reparameterisations=True,
              use_default_reparameterisations=False),
         {"rescaletobounds_x_0": "RescaleToBounds", "scaleandshift_x_1": "ScaleAndShift"}),
    ],
    ids=lambda v: str(v) if isinstance(v, dict) and "reparameterisations" in v else "",
)
def test_standard_sampler_takes_reparameterisations(tmp_path, options, stack):
    """Each spec form reaches the flow proposal through the sampler: its
    stack is built, verified, fitted, and a pool drawn through it lies
    in the prior bounds."""
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), nlive=100, seed=3, device="cpu",
                     plot=False, checkpointing=False, flow_config=FLOW_CONFIG, **options)
    ns = fs.ns
    ns.initialise()
    proposal = ns.flow_proposal
    assert {k: type(r).__name__ for k, r in proposal._reparameterisation.items()} == stack
    assert proposal.reverse_reparameterisations == options.get("reverse_reparameterisations", False)
    proposal.train(ns.live_points.copy())
    proposal.populate(None, n_samples=50)
    assert proposal.samples.size == 50
    assert _in_bounds(proposal.samples, ns.model) and np.isfinite(proposal.samples["logL"]).all()


def test_standard_sampler_takes_the_fixed_values(tmp_path):
    fixed = dict(
        stopping=0.1, stopping_criterion="dlogZ", max_iteration=None, checkpointing=False, plot=False,
        cooldown=200, acceptance_threshold=0.01, retrain_acceptance=True, train_on_empty=True,
        reset_flow=False, shrinkage_expectation="logt", n_pool=None, pool=None, close_pool=False,
        simulated_evidence_error=True, maximum_uninformed=None, flow_class=None,
    )
    ns = NestedSampler(IntegrationTestModel(2), nlive=50, output=str(tmp_path), device="cpu", **fixed)
    assert ns.tolerance == 0.1 and ns.maximum_uninformed == 500
    # the batched consume and device stepping, fixed until the port took them
    ns = NestedSampler(IntegrationTestModel(2), nlive=50, output=str(tmp_path), device="cpu",
                       batched_bookkeeping=False, device_bookkeeping=False)
    assert ns.batched_bookkeeping is False and ns.device_bookkeeping is False


#: the Gaussian-mixture configuration (``FLAGSHIP_INS_MIXTURE``) cut for
#: the CPU: nlive 2000 -> 400, min_samples 500 -> 100, the ESS tolerance
#: 3000 -> 600, 500 -> 150 epochs at most, and the redraw's ESS 2000 ->
#: 400; the flow and the criteria as there
MIXTURE_CPU = dict(
    importance_nested_sampler=True,
    nlive=400,
    min_samples=100,
    seed=1234,
    stopping_criterion=["ratio", "ess"],
    tolerance=[0.0, 600],
    check_criteria="all",
    training_config=dict(max_epochs=150),
)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_mixture_with_redraw_on_the_cpu(tmp_path, package):
    """The Gaussian-mixture configuration at reduced nlive and ESS
    tolerance, with the final redraw, in each package: the redrawn logZ
    within 3σ of the analytic value, the posterior samples and the
    returned samples inside the prior bounds."""
    model = GaussianMixture(2)
    if package == "torch":
        fs = FlowSampler(model, output=str(tmp_path), device="cpu", plot=False, checkpointing=False, **MIXTURE_CPU)
        _, samples = fs.run(plot=False, save=False, redraw_samples=True, n_posterior_samples=400)
    else:
        with jax.default_device(jax.devices("cpu")[0]):
            fs = JaxFlowSampler(JaxGaussianMixture(2), output=str(tmp_path), resume=False, plot=False,
                                checkpointing=False, **MIXTURE_CPU)
            _, samples = fs.run(plot=False, save=False, redraw_samples=True, n_posterior_samples=400)
    analytic = model.analytic_log_evidence
    assert fs.logZ == fs.ns.final_log_evidence
    assert abs(fs.logZ - analytic) < 3 * fs.logZ_error, (fs.logZ, fs.logZ_error)
    assert abs(fs.initial_logZ - analytic) < 3 * fs.initial_logZ_error
    post = fs.posterior_samples
    assert len(post) and _in_bounds(post, model) and _in_bounds(samples, model)
    # both modes are in the posterior
    assert (post["x_0"] > 0).any() and (post["x_0"] < 0).any()


@pytest.mark.parametrize("ins", [False, True], ids=["standard", "ins"])
@pytest.mark.parametrize("option", [dict(close_pool=True), dict(plot_posterior=True), dict(plot_indices=True)],
                         ids=lambda v: next(iter(v)))
def test_run_reference_options(tmp_path, ins, option):
    """``run``'s pool and plot options, as the JAX package takes them:
    ``close_pool`` closes the model's pool after the run; with
    ``plot=True`` ``plot_posterior`` writes the posterior plot and
    ``plot_indices`` the insertion indices' (the importance sampler's
    run passes it on to the redraw, which does not run here, as in the
    JAX package)."""
    if ins:
        sampler = dict(importance_nested_sampler=True, nlive=100, min_samples=50, max_iteration=1,
                       flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
                       training_config=dict(max_epochs=5, patience=3, batch_size=100), device="cpu")
    else:
        sampler = SMALL_STANDARD
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), checkpointing=False, plot=False,
                     n_pool=1 if "close_pool" in option else None, **sampler)
    plots = "close_pool" not in option
    with time_limit(120):
        fs.run(plot=plots, save=False, **option)
    written = set(os.listdir(tmp_path))
    if "close_pool" in option:
        assert fs.ns.model.pool is None
    elif "plot_posterior" in option:
        assert "posterior_distribution.png" in written
    else:
        assert ("insertion_indices.png" in written) == (not ins)
