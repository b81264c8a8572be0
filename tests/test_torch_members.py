"""The last members of the public classes, each against the JAX member.

Host float64 state is compared bit for bit, flow outputs to float32
tolerance on weights converted by ``flows/convert.py`` (K1 and K2 through
their plain versions on the CPU), and draws statistically. Each test
names the members it holds (``tests/test_torch_api_surface.py`` checks
that every one of them is named here)."""

import dataclasses
import datetime
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu import config as jax_config
from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu.flowmodel.importance import ImportanceFlowModel as JaxImportanceFlowModel
from nessai_tpu.flowmodel.config import TrainingConfig as JaxTrainingConfig
from nessai_tpu.livepoint import numpy_array_to_live_points as jax_to_live_points
from nessai_tpu.proposal import AnalyticProposal as JaxAnalyticProposal
from nessai_tpu.proposal.flowproposal import FlowProposal as JaxFlowProposal
from nessai_tpu.proposal.flowproposal.base import BaseFlowProposal as JaxBaseFlowProposal
from nessai_tpu.reparameterisations import CombinedReparameterisation as JaxCombined
from nessai_tpu.reparameterisations import RescaleToBounds as JaxRescaleToBounds
from nessai_tpu.reparameterisations import ScaleAndShift as JaxScaleAndShift
from nessai_tpu.samplers.base import BaseNestedSampler as JaxBaseNestedSampler
from nessai_tpu.samplers.importancesampler import ImportanceNestedSampler as JaxINS
from nessai_tpu.samplers.nestedsampler import NestedSampler as JaxNestedSampler
from nessai_tpu.evidence import _NSIntegralState as JaxNSState
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch import config
from nessai_tpu_torch.evidence import _NSIntegralState
from nessai_tpu_torch.flowmodel import FlowModel, ImportanceFlowModel
from nessai_tpu_torch.flowmodel.config import TrainingConfig
from nessai_tpu_torch.flows import params_from_jax, params_to_jax
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.proposal import AnalyticProposal
from nessai_tpu_torch.proposal.flowproposal import FlowProposal
from nessai_tpu_torch.proposal.flowproposal.base import BaseFlowProposal
from nessai_tpu_torch.reparameterisations import CombinedReparameterisation, RescaleToBounds, ScaleAndShift
from nessai_tpu_torch.samplers import ImportanceNestedSampler
from nessai_tpu_torch.samplers.base import BaseNestedSampler
from nessai_tpu_torch.samplers.nestedsampler import NestedSampler
from nessai_tpu_torch.utils.testing import IntegrationTestModel

#: float32 tolerance of flow outputs on converted weights
ATOL = RTOL = 1e-5
FLOWS = {
    "realnvp": dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1),
    "nsf": dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1, ftype="nsf"),
    "realnvp_d5": dict(n_inputs=5, n_blocks=2, n_neurons=8, n_layers=1),
}


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


def _pair(tmp_path, flow="realnvp", training_config=None, seed=0, cls=(JaxFlowModel, FlowModel)):
    """A JAX and a port flow model with the same (perturbed) weights."""
    cfg = FLOWS[flow] if isinstance(flow, str) else flow
    jfm = cls[0](cfg, training_config, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed))
    jfm.initialise()
    p = _perturbed(jfm.params, seed + 1)
    jfm.params = jax.tree.map(jnp.asarray, p)
    jfm.reset_optimiser()
    tfm = cls[1](cfg, training_config, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed), device="cpu")
    tfm.initialise()
    params_from_jax(tfm.flow, p)
    tfm.reset_optimiser()
    return jfm, tfm


def _z(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# ----------------------------------------------------------------------
# NestedSampler and BaseNestedSampler
# ----------------------------------------------------------------------
def _ns_states(seed=0, n=400, nlive=50):
    """Both packages' evidence states fed one increasing logL sequence, and
    the nested samples' birth iterations."""
    rng = np.random.default_rng(seed)
    logls = np.sort(rng.normal(0.0, 3.0, n))
    states = (JaxNSState(nlive), _NSIntegralState(nlive))
    for state in states:
        for i, logl in enumerate(logls):
            state.increment(float(logl), nlive=nlive if i < n - nlive else n - i)
    samples = np.zeros(n, dtype=[("logL", "f8"), ("it", "i4")])
    samples["logL"] = logls
    samples["it"] = np.minimum(np.arange(n), np.maximum(0, np.arange(n) - nlive + rng.integers(0, 5, n)))
    return states, samples


def test_birth_log_likelihoods_and_posterior_ess_equal_jax():
    (jstate, tstate), samples = _ns_states()
    jax_ns = types.SimpleNamespace(state=jstate, nested_samples_array=samples)
    ours = types.SimpleNamespace(state=tstate, nested_samples_array=samples)
    np.testing.assert_array_equal(
        NestedSampler.birth_log_likelihoods.fget(ours), JaxNestedSampler.birth_log_likelihoods.fget(jax_ns)
    )
    ess = NestedSampler.posterior_effective_sample_size.fget(ours)
    assert ess == JaxNestedSampler.posterior_effective_sample_size.fget(jax_ns)
    assert 1.0 < ess < len(samples)
    # the base class leaves it to each sampler, in both packages
    for cls in (BaseNestedSampler, JaxBaseNestedSampler):
        with pytest.raises(NotImplementedError):
            cls.posterior_effective_sample_size.fget(ours)


def test_simulate_evidence_uncertainty_draws_as_jax():
    (jstate, tstate), _ = _ns_states(seed=3)
    out = []
    for cls, state in ((JaxNestedSampler, jstate), (NestedSampler, tstate)):
        stub = types.SimpleNamespace(state=state, rng=np.random.default_rng(7))
        given = cls.simulate_evidence_uncertainty(stub, 64, rng=np.random.default_rng(11))
        own = cls.simulate_evidence_uncertainty(stub, 64)
        out.append((given, own))
    for a, b in zip(*out):
        assert a.shape == (64,)
        # the port's scratch is float64 where the JAX package's is float32
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    # the same rng gives the same draws
    assert not np.array_equal(out[1][0], out[1][1])


def test_proposal_population_time_sums_both_proposals():
    stub = types.SimpleNamespace(
        _uninformed_proposal=types.SimpleNamespace(population_time=datetime.timedelta(seconds=1.5)),
        _flow_proposal=types.SimpleNamespace(population_time=datetime.timedelta(microseconds=250)),
    )
    ours = NestedSampler.proposal_population_time.fget(stub)
    assert ours == JaxNestedSampler.proposal_population_time.fget(stub) == datetime.timedelta(seconds=1.50025)


def test_members_on_a_run(tmp_path):
    """The members on a short run of the port's sampler: every nested
    sample's birth threshold lies below its own logL."""
    from nessai_tpu_torch.flowsampler import FlowSampler

    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path), nlive=100, max_iteration=300, seed=5,
                     plot=False, checkpointing=False, resume=False, device="cpu",
                     flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1))
    fs.run(plot=False, save=False)
    ns = fs.ns
    births = ns.birth_log_likelihoods
    its = ns.nested_samples_array["it"]
    logl = ns.nested_samples_array["logL"]
    # the JAX member on the same state: the initial points (it = -1) read
    # the last threshold, as there
    stub = types.SimpleNamespace(state=ns.state, nested_samples_array=ns.nested_samples_array)
    np.testing.assert_array_equal(births, JaxNestedSampler.birth_log_likelihoods.fget(stub))
    assert births.shape == logl.shape and np.all(births[its >= 0] <= logl[its >= 0])
    assert ns.proposal_population_time >= ns._uninformed_proposal.population_time
    assert ns.posterior_effective_sample_size > 1
    assert np.isfinite(ns.simulate_evidence_uncertainty(20)).all()


# ----------------------------------------------------------------------
# ImportanceNestedSampler
# ----------------------------------------------------------------------
def _ins_pair(tmp_path, **kwargs):
    kwargs = dict(nlive=200, min_samples=50, seed=8, draw_iid_live=False, **kwargs)
    jns = JaxINS(JaxModel(2), output=str(tmp_path / "jax"), checkpointing=False, plot=False, **kwargs)
    tns = ImportanceNestedSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), checkpointing=False,
                                  plot=False, device="cpu", **kwargs)
    for ns in (jns, tns):
        ns.initialise_history()
    return jns, tns


def _structured(u, it, log_q, to_live_points, proposal):
    s = to_live_points(u, ["x_0", "x_1"])
    x = 20.0 * u - 10.0
    s["logL"] = -0.5 * np.sum(x**2, axis=1) - np.log(2 * np.pi)
    s["it"] = it
    s["logU"] = 0.0
    s["logQ"] = proposal.compute_meta_proposal_from_log_q(log_q)
    s["logW"] = s["logU"] - s["logQ"]
    return s


def _scripted_levels(pairs, rng, n=200):
    """Give each sampler the same initial samples, then script the flow's
    draws and its column of log_q from ``rng``: the members' bookkeeping
    runs on the host as in a run, without training a flow."""
    u = rng.uniform(size=(n, 2))
    log_q = np.zeros((n, 1))
    for ns, to_lp in pairs:
        ns.sample_counts[-1] = n
        ns.training_samples.add_initial_samples(_structured(u, -1, log_q, to_lp, ns.proposal), log_q)
    script = dict(u=[], log_q=[], column=[])

    def draw(ns, to_lp, k):
        def draw_n_samples(m):
            i = draw.calls[id(ns)]
            draw.calls[id(ns)] += 1
            if len(script["u"]) <= i:
                width = 0.6 ** (i + 1)
                script["u"].append(0.5 + width * (rng.uniform(size=(m, 2)) - 0.5))
                n_levels = len(ns.proposal.weights_array)
                script["log_q"].append(np.concatenate([np.zeros((m, 1)), rng.normal(1.0, 1.0, (m, n_levels - 1))], 1))
            return _structured(script["u"][i], ns.iteration, script["log_q"][i], to_lp, ns.proposal), script["log_q"][i]

        def update_log_q(samples, log_q):
            i = draw.columns[id(ns)]
            draw.columns[id(ns)] += 1
            if len(script["column"]) <= i:
                script["column"].append(rng.normal(0.0, 1.0, (len(samples), 1)))
            return np.concatenate([log_q, script["column"][i]], axis=1)

        draw.calls[id(ns)] = draw.columns[id(ns)] = 0
        ns.draw_n_samples = draw_n_samples
        ns.proposal.update_log_q = update_log_q
        ns.proposal.train = lambda *a, **k: None

    draw.calls, draw.columns = {}, {}
    for ns, to_lp in pairs:
        draw(ns, to_lp, n)


def test_ins_members_follow_a_level_as_jax(tmp_path):
    """``log_q``, ``posterior_samples_set``, ``current_proposal_entropy``,
    ``sort_samples`` and ``add_level_post_sampling``: two levels and a
    level after the sampling, bit for bit."""
    jns, tns = _ins_pair(tmp_path)
    pairs = ((jns, jax_to_live_points), (tns, numpy_array_to_live_points))
    _scripted_levels(pairs, np.random.default_rng(20261018))
    assert np.isnan(tns.current_proposal_entropy) and np.isnan(jns.current_proposal_entropy)
    for level in range(2):
        for ns, _ in pairs:
            ns.iteration = level
            ns.update_log_likelihood_threshold(ns.determine_log_likelihood_threshold(ns.live_points_unit))
            ns.remove_samples()
            ns.add_new_proposal_weight(level, 200)
            ns.add_and_update_points(200)
            ns.update_evidence()
        assert tns.current_proposal_entropy == jns.current_proposal_entropy
        np.testing.assert_array_equal(tns.log_q, jns.log_q)
        assert tns.posterior_samples_set is tns.training_samples
        assert jns.posterior_samples_set is jns.training_samples
    for ns, _ in pairs:
        ns.iteration = 2
        n_nested = len(ns.training_samples.nested_samples_indices)
        assert ns.add_level_post_sampling(ns.training_samples.samples[-50:], 100) is None
        assert len(ns.training_samples.nested_samples_indices) >= n_nested + 100
        assert ns.iteration == 3
    assert tns.log_evidence == jns.log_evidence
    np.testing.assert_array_equal(tns.log_q, jns.log_q)
    for field in tns.training_samples.samples.dtype.names:
        np.testing.assert_array_equal(tns.training_samples.samples[field], jns.training_samples.samples[field])
    np.testing.assert_array_equal(tns.training_samples.is_nested, jns.training_samples.is_nested)
    # sort_samples: by logL, with arrays aligned to the samples
    samples = tns.training_samples.samples[::-1].copy()
    extra = np.arange(len(samples))
    ours, theirs = tns.sort_samples(samples, extra), JaxINS.sort_samples(samples, extra)
    np.testing.assert_array_equal(ours[1], theirs[1])
    alone = ImportanceNestedSampler.sort_samples(samples), JaxINS.sort_samples(samples)
    for field in samples.dtype.names:
        np.testing.assert_array_equal(ours[0][field], theirs[0][field])
        np.testing.assert_array_equal(alone[0][field], alone[1][field])
    assert np.all(np.diff(ours[0]["logL"]) >= 0)


def test_ins_check_configuration_and_get_proposal(tmp_path):
    jns, tns = _ins_pair(tmp_path)
    assert tns.check_configuration() is jns.check_configuration() is True
    for kwargs in (dict(min_samples=300), dict(min_remove=300)):
        for cls, model in ((JaxINS, JaxModel(2)), (ImportanceNestedSampler, IntegrationTestModel(2))):
            extra = dict(device="cpu") if cls is ImportanceNestedSampler else {}
            with pytest.raises(ValueError, match="must be less than `nlive`"):
                cls(model, output=str(tmp_path / "bad"), nlive=200, checkpointing=False, plot=False, **kwargs, **extra)
    ours = tns.get_proposal(subdir="other", flow_config=dict(n_blocks=2, n_neurons=8), device="cpu")
    theirs = jns.get_proposal(subdir="other", flow_config=dict(n_blocks=2, n_neurons=8))
    assert type(ours).__name__ == type(theirs).__name__ == "ImportanceFlowProposal"
    assert ours.output == str(tmp_path / "torch" / "other") + "/"
    assert theirs.output == str(tmp_path / "jax" / "other") + "/"
    assert type(tns.proposal) is type(ours)


# ----------------------------------------------------------------------
# FlowModel (and through it ImportanceFlowModel), Flow
# ----------------------------------------------------------------------
@pytest.mark.parametrize("flow", ["realnvp", "nsf", "realnvp_d5"])
def test_sample_and_log_prob_given_z_and_alt_dist(tmp_path, flow):
    jfm, tfm = _pair(tmp_path, flow)
    z = _z(300, FLOWS[flow]["n_inputs"], 4)
    x_t, lp_t = tfm.sample_and_log_prob(z=z)
    x_j, lp_j = jfm.sample_and_log_prob(z=z)
    assert x_t.dtype == lp_t.dtype == np.float64 and x_t.shape == z.shape
    # the spline's inverse solves a quadratic in float32: 1e-4 there
    tol = 1e-4 if flow == "nsf" else ATOL
    np.testing.assert_allclose(x_t, x_j, atol=tol, rtol=tol)
    np.testing.assert_allclose(lp_t, lp_j, atol=tol, rtol=tol)
    alt = types.SimpleNamespace(log_prob=lambda z: -0.25 * np.sum(np.asarray(z) ** 2, axis=1))
    _, alt_t = tfm.sample_and_log_prob(z=z, alt_dist=alt)
    _, alt_j = jfm.sample_and_log_prob(z=z, alt_dist=alt)
    np.testing.assert_allclose(alt_t, alt_j, atol=tol, rtol=tol)


@pytest.mark.parametrize("flow", ["realnvp", "nsf"])
def test_sample_and_log_prob_draws(tmp_path, flow):
    """Draws: the port's log-density of its draws is the JAX flow's log_prob
    of the same points; the latent draws are standard normal."""
    jfm, tfm = _pair(tmp_path, flow)
    x, lp = tfm.sample_and_log_prob(2000)
    assert x.shape == (2000, 2) and lp.shape == (2000,)
    np.testing.assert_allclose(lp, jfm.log_prob(x), atol=1e-4, rtol=1e-4)
    z_t, z_j = tfm.sample_latent_distribution(20000), jfm.sample_latent_distribution(20000)
    for z in (z_t, z_j):
        assert z.shape == (20000, 2)
        # 5 sigma of the sample mean and standard deviation
        assert np.all(np.abs(z.mean(0)) < 5 / np.sqrt(20000))
        assert np.all(np.abs(z.std(0) - 1) < 5 / np.sqrt(2 * 20000))
    for fm in (tfm, jfm):
        with pytest.raises(NotImplementedError):
            fm.sample_latent_distribution(3, context=np.zeros((3, 1)))


@pytest.mark.parametrize("temperature", [None, 1.0, 0.5])
def test_base_distribution_log_prob_equals_jax(tmp_path, temperature):
    jfm, tfm = _pair(tmp_path, "realnvp_d5")
    z = _z(100, 5, 6)
    np.testing.assert_allclose(
        tfm.base_distribution_log_prob(z, temperature=temperature),
        jfm.base_distribution_log_prob(z, temperature=temperature), atol=ATOL, rtol=RTOL,
    )
    # the flow's own member (the context is taken and not used)
    zt = torch.as_tensor(z)
    np.testing.assert_allclose(
        tfm.flow.base_distribution_log_prob(zt, context=None).numpy(),
        np.asarray(jfm.flow.base_distribution_log_prob(jfm.params, jnp.asarray(z))), atol=ATOL, rtol=RTOL,
    )


def _grads_as_jax(flow):
    """The flow's parameter gradients in the JAX package's tree."""
    grads = {}
    for name, p in flow.named_parameters():
        grads[name] = p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
    with torch.no_grad():
        saved = {name: p.detach().clone() for name, p in flow.named_parameters()}
        for name, p in flow.named_parameters():
            p.copy_(grads[name])
        out = params_to_jax(flow)
        for name, p in flow.named_parameters():
            p.copy_(saved[name])
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("flow", ["realnvp", "nsf"])
def test_flow_loss_and_its_gradient_equal_jax(tmp_path, flow, weighted):
    jfm, tfm = _pair(tmp_path, flow)
    rng = np.random.default_rng(9)
    x = (1.5 * rng.standard_normal((256, 2))).astype(np.float32)
    w = rng.uniform(0.1, 2.0, 256).astype(np.float32) if weighted else None
    tfm.flow.zero_grad()
    loss_t = tfm.flow.loss(torch.as_tensor(x), None if w is None else torch.as_tensor(w))
    loss_t.backward()
    from nessai_tpu.flowmodel.base import _combine_params, _partition_params

    wj = None if w is None else jnp.asarray(w)
    diff, aux = _partition_params(jfm.params)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda d: jfm.flow.loss(_combine_params(d, aux), jnp.asarray(x), wj)))(diff)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)
    ours = jax.tree.leaves(_grads_as_jax(tfm.flow))
    assert len(ours) == len(grads_j)
    n_float = 0
    for a, b in zip(ours, grads_j):
        if b is not None:
            # gradients summed over the batch in float32
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-4)
            n_float += 1
    assert n_float > 4


def test_optimiser_members_keep_optax_defaults(tmp_path):
    """``get_optimiser`` and ``optimiser_kwargs``: one step of each package's
    optimiser on the same gradients gives the same parameters."""
    for name, kwargs in (("adamw", {}), ("adam", dict(eps=1e-6)), ("sgd", dict(momentum=0.9))):
        tc = dict(optimiser=name, optimiser_kwargs=kwargs, lr=0.01)
        jfm, tfm = _pair(tmp_path / name, training_config=tc)
        assert tfm.optimiser_kwargs == jfm.optimiser_kwargs == kwargs
        params = [p for p in tfm.flow.parameters()]
        rng = np.random.default_rng(2)
        grads = [(0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32) for p in params]
        start = [p.detach().numpy().copy() for p in params]
        opt = tfm.get_optimiser()
        for p, g in zip(params, grads):
            p.grad = torch.as_tensor(g)
        opt.step()
        import optax

        jopt = jfm.get_optimiser()
        tree = [jnp.asarray(s) for s in start]
        updates, _ = jopt.update([jnp.asarray(g) for g in grads], jopt.init(tree), tree)
        for p, b in zip(params, optax.apply_updates(tree, updates)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)
    # a name or keyword arguments given to the member override the configured ones
    _, tfm = _pair(tmp_path / "override")
    assert tfm.get_optimiser("adam", eps=1e-3).defaults["eps"] == 1e-3
    with pytest.raises(ValueError):
        tfm.get_optimiser("lbfgs")


def test_check_batch_size_and_noise_members(tmp_path):
    jfm, tfm = _pair(tmp_path, training_config=dict(batch_size=100))
    for n, bs in ((500, None), (500, 64), (120, "all"), (300, 300)):
        assert tfm.check_batch_size(np.zeros((n, 2)), bs) == (n if bs == "all" else (bs or 100))
        if bs != "all":
            assert tfm.check_batch_size(n, bs) == jfm.check_batch_size(n, bs)
    for fm in (tfm, jfm):
        with pytest.raises(ValueError, match="batch size of 1"):
            fm.check_batch_size(100, 1)
    assert FlowModel.noise_scale is JaxFlowModel.noise_scale is None
    assert FlowModel.noise_type is JaxFlowModel.noise_type is None
    for fm in (tfm, jfm):
        fm.noise_type, fm.noise_scale = "constant", 0.3
    x = np.random.default_rng(0).standard_normal((50, 2)).astype(np.float32)
    ours = tfm._noise_sigma([torch.as_tensor(x)])[0].numpy()
    np.testing.assert_array_equal(ours, jfm._noise_sigma(x))


def test_move_to_numpy_array_to_tensor_and_dtype(tmp_path, monkeypatch):
    assert TrainingConfig().dtype == JaxTrainingConfig().dtype == "float32"
    jfm, tfm = _pair(tmp_path)
    t = tfm.numpy_array_to_tensor(np.arange(6.0).reshape(3, 2))
    assert t.dtype == torch.float32 and t.device == tfm.device
    assert str(jfm.numpy_array_to_tensor(np.arange(6.0)).dtype) == "float32"
    z = _z(50, 2, 1)
    before = tfm.sample_and_log_prob(z=z)
    tfm.move_to("cpu", update_default=True)
    np.testing.assert_array_equal(tfm.sample_and_log_prob(z=z)[0], before[0])
    assert jfm.move_to("cpu") is None
    # the device rule: None is the GPU, and without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tfm.move_to(None)
    # on a mesh every entry moves
    from nessai_tpu_torch.parallel import get_mesh

    mfm = FlowModel(FLOWS["realnvp"], output=str(tmp_path / "mesh"), rng=np.random.default_rng(0),
                    mesh=get_mesh(devices=["cpu", "cpu"]))
    mfm.initialise()
    mfm.move_to("cpu")
    assert mfm.mesh.size == 2 and all(d.type == "cpu" for d in mfm.mesh.devices)
    assert len(mfm.replicas) == 2


def test_setup_from_input_dict_and_update_mask(tmp_path):
    jfm, tfm = _pair(tmp_path)
    for fm in (jfm, tfm):
        assert fm.update_mask() is None
        fm.setup_from_input_dict(dict(n_inputs=3, n_blocks=3, n_neurons=6), dict(lr=0.02, patience=7))
        assert fm.flow_config.n_blocks == 3 and fm.training_config.lr == 0.02
    read = [
        {n: json.load(open(tmp_path / side / n)) for n in ("flow_config.json", "training_config.json")}
        for side in ("jax", "torch")
    ]
    training = read[0]["training_config.json"]
    assert read[1]["training_config.json"] == {k: training[k] for k in read[1]["training_config.json"]}
    flow = read[0]["flow_config.json"]
    assert {k: flow[k] for k in ("n_inputs", "n_blocks", "n_neurons")} == {
        k: read[1]["flow_config.json"][k] for k in ("n_inputs", "n_blocks", "n_neurons")
    }


def _changed(before, after):
    return [not np.array_equal(a, b) for a, b in zip(before, after)]


def test_freeze_transform_trains_the_base_alone(tmp_path):
    """``freeze_transform``: after a frozen epoch the transform's parameters
    are bit-equal and the LARS base's have moved, in both packages; after
    ``unfreeze_transform`` the transform moves again."""
    cfg = dict(FLOWS["realnvp"], distribution="lars", distribution_kwargs=dict(n_neurons=8))
    tc = dict(max_epochs=1, batch_size=100, val_size=0.1)
    jfm, tfm = _pair(tmp_path, cfg, training_config=tc)
    x = (np.random.default_rng(4).standard_normal((400, 2)) * 1.5).astype(np.float32)

    def split(fm):
        if fm is jfm:
            p = jax.tree.map(np.asarray, jfm.params)
            return jax.tree.leaves(p["bijector"]), jax.tree.leaves(p["base"])
        named = dict(tfm.flow.named_parameters())
        return ([v.detach().numpy().copy() for k, v in named.items() if not k.startswith("base.")],
                [v.detach().numpy().copy() for k, v in named.items() if k.startswith("base.")])

    def epoch(fm):
        fm.train(x, max_epochs=1, save=False) if fm is tfm else fm.train(x, max_epochs=1, plot=False, save=False)

    for fm in (jfm, tfm):
        # the first training also takes the ActNorm layers' data
        # initialisation, which freezing does not stop
        epoch(fm)
        fm.freeze_transform()
        transform, base = split(fm)
        epoch(fm)
        t_after, b_after = split(fm)
        assert not any(_changed(transform, t_after)), type(fm)
        assert any(_changed(base, b_after)), type(fm)
        fm.unfreeze_transform()
        assert fm._transform_frozen is False
        epoch(fm)
        assert any(_changed(t_after, split(fm)[0])), type(fm)


def test_importance_flow_model_model(tmp_path):
    jfm, tfm = _pair(tmp_path, cls=(JaxImportanceFlowModel, ImportanceFlowModel))
    assert tfm.model is None and jfm.model is None
    tfm.model = tfm.flow
    jfm.model = jfm.params
    assert tfm.n_models == jfm.n_models == 1
    assert tfm.model is tfm.models[-1] and not any(p.requires_grad for p in tfm.model.parameters())
    x = _z(64, 2, 3)
    np.testing.assert_allclose(tfm.log_prob_ith(x, 0), jfm.log_prob_ith(x, 0), atol=ATOL, rtol=RTOL)
    tfm.model = None
    jfm.model = None
    assert tfm.n_models == jfm.n_models == 1


# ----------------------------------------------------------------------
# BaseFlowProposal and Proposal
# ----------------------------------------------------------------------
def _proposal_pair(tmp_path):
    models = (JaxModel(2), IntegrationTestModel(2))
    for m in models:
        m.set_rng(np.random.default_rng(0))
    jp = JaxFlowProposal(models[0], output=str(tmp_path / "jax"), flow_config=FLOWS["realnvp"], poolsize=100,
                         rng=np.random.default_rng(1))
    tp = FlowProposal(models[1], output=str(tmp_path / "torch"), flow_config=FLOWS["realnvp"], poolsize=100,
                      rng=np.random.default_rng(1), device="cpu")
    for p in (jp, tp):
        p.initialise()
    p = _perturbed(jp.flow.params, 2)
    jp.flow.params = jax.tree.map(jnp.asarray, p)
    params_from_jax(tp.flow.flow, p)
    return jp, tp


def test_flow_proposal_members_equal_jax(tmp_path):
    jp, tp = _proposal_pair(tmp_path)
    for name in ("population_dtype", "internal_prime_parameters", "x_prime_internal_dtype", "flow_dims"):
        assert getattr(tp, name) == getattr(jp, name), name
    for p in (tp, jp):
        with pytest.warns(DeprecationWarning, match="prime_dims"):
            assert p.rescaled_dims == p.prime_dims == 2
    z = _z(200, 2, 5)
    for t in (None, 0.5):
        np.testing.assert_allclose(tp.latent_log_prob(z, temperature=t), jp.latent_log_prob(z, temperature=t),
                                   atol=ATOL, rtol=RTOL)
    # the base's draws, without the truncation rules' own
    assert BaseFlowProposal.sample_latent_distribution(tp, 7).shape == (7, 2)
    assert JaxBaseFlowProposal.sample_latent_distribution(jp, 7).shape == (7, 2)
    # check_prior_bounds: the points inside the prior and their rows
    rng = np.random.default_rng(3)
    pts = rng.uniform(-15, 15, (300, 2))
    extra = rng.standard_normal(300)
    out_t = tp.check_prior_bounds(numpy_array_to_live_points(pts, ["x_0", "x_1"]), extra)
    out_j = jp.check_prior_bounds(jax_to_live_points(pts, ["x_0", "x_1"]), extra)
    assert 0 < len(out_t[0]) < 300
    for name in ("x_0", "x_1"):
        np.testing.assert_array_equal(out_t[0][name], out_j[0][name])
    np.testing.assert_array_equal(out_t[1], out_j[1])
    # reset_model_weights: fresh weights in both
    before = [v.clone() for v in tp.flow.flow.state_dict().values()]
    jbefore = jax.tree.leaves(jax.tree.map(np.asarray, jp.flow.params))
    tp.reset_model_weights()
    jp.reset_model_weights()
    assert any(not torch.equal(a, b) for a, b in zip(before, tp.flow.flow.state_dict().values()))
    assert any(_changed(jbefore, jax.tree.leaves(jax.tree.map(np.asarray, jp.flow.params))))


def test_proposal_evaluate_likelihoods_and_reset():
    models = (JaxModel(2), IntegrationTestModel(2))
    models[1].device = "cpu"
    props = (JaxAnalyticProposal(models[0], rng=np.random.default_rng(0)),
             AnalyticProposal(models[1], rng=np.random.default_rng(0)))
    pts = np.random.default_rng(6).uniform(-10, 10, (50, 2))
    for p, to_lp in zip(props, (jax_to_live_points, numpy_array_to_live_points)):
        p.samples = to_lp(pts, ["x_0", "x_1"])
        p.evaluate_likelihoods()
    # the model's likelihood runs in float32 on the device in both packages
    np.testing.assert_allclose(props[0].samples["logL"], props[1].samples["logL"], rtol=1e-6)
    assert models[0].likelihood_evaluations == models[1].likelihood_evaluations == 50
    for p in props:
        p.indices = [1, 2]
        p.populated = True
        p.reset()
        assert p.samples == [] and p.indices == [] and p.populated is False


# ----------------------------------------------------------------------
# Reparameterisations and the configuration
# ----------------------------------------------------------------------
def test_reparameterisation_members_equal_jax():
    bounds = {"x": np.array([-2.0, 5.0]), "y": np.array([0.0, 3.0])}
    pts = np.random.default_rng(8).uniform([-1.0, 0.5], [4.0, 2.5], (200, 2))
    scales = []
    for cls, combined, to_lp in ((RescaleToBounds, CombinedReparameterisation, numpy_array_to_live_points),
                                 (JaxRescaleToBounds, JaxCombined, jax_to_live_points)):
        assert cls(parameters=["x"], prior_bounds=bounds, update_bounds=True).update_bounds_enabled is True
        assert cls(parameters=["x"], prior_bounds=bounds, update_bounds=False).update_bounds_enabled is False
        r = cls(parameters=["x", "y"], prior_bounds=bounds, update_bounds=True)
        c = combined()
        c.add_reparameterisations(r)
        c.update_bounds(to_lp(pts, ["x", "y"]))
        scales.append({k: np.asarray(v) for k, v in r.bounds.items()})
    for k in scales[0]:
        np.testing.assert_array_equal(scales[0][k], scales[1][k])
    for cls in (ScaleAndShift, JaxScaleAndShift):
        assert cls(parameters=["x"], prior_bounds=bounds, scale=2.0, shift=1.0).as_affine() == {"x": (2.0, 1.0)}
    affine = [cls(parameters=["x", "y"], prior_bounds=bounds, estimate_scale=True, estimate_shift=True)
              for cls in (ScaleAndShift, JaxScaleAndShift)]
    for r, to_lp in zip(affine, (numpy_array_to_live_points, jax_to_live_points)):
        r.update(to_lp(pts, ["x", "y"]))
    assert affine[0].as_affine() == affine[1].as_affine()


def test_configuration_members_equal_jax():
    ours, theirs = config.LivepointsConfig(), jax_config.LivepointsConfig()
    assert ours.core_parameters_dtype == theirs.core_parameters_dtype
    assert ours.core_parameters_defaults[2:] == theirs.core_parameters_defaults[2:]
    assert all(np.isnan(v) for v in ours.core_parameters_defaults[:2] + theirs.core_parameters_defaults[:2])
    for cfg in (ours, theirs):
        cfg.default_float_value = -np.inf
        cfg.reset_properties()
    assert ours.core_parameters_defaults == theirs.core_parameters_defaults == (-np.inf, -np.inf, 0)
    assert ours.non_sampling_defaults == theirs.non_sampling_defaults
    for name in ("livepoints", "plotting", "general", "compute"):
        a, b = getattr(config, name).asdict(), getattr(jax_config, name).asdict()
        # the JAX package's live-point configuration also lists its caches
        assert a == {k: b[k] for k in a if k in b} and set(b) - set(a) <= {
            f for f in b if f.startswith("_")
        } | {"use_pallas", "jit", "matmul_precision"} or name == "compute", name
    assert dataclasses.asdict(TrainingConfig())["dtype"] == "float32"
