"""The device populate loop of the port
(``FlowProposal._device_loop_populate``) against the JAX package's
(``nessai_tpu/proposal/flowproposal/flowproposal.py:625-985``): the same
eligibility on the same configurations, the same uniform-box detection,
a pool drawn from the rounds populate's distribution, the same host
budget loop (calls, rounds, breaks, warnings, counts and host stream)
with each call's accepted and proposed counts scripted into both, and a
whole run of each package within 3 sigma of the analytic evidence and of
the other. Mirrors the JAX package's ``tests/test_device_loop.py``."""

import logging

import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.model import Model as JaxBaseModel
from nessai_tpu.proposal import FlowProposal as JaxFlowProposal
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.model import Model
from nessai_tpu_torch.proposal import FlowProposal
from nessai_tpu_torch.proposal.flowproposal.flowproposal import device_loop_counts
from nessai_tpu_torch.proposal.rejection import prior_populate_counts
from nessai_tpu_torch.utils.testing import IntegrationTestModel
from tests.test_fused_reparams import AngleGaussianModel as JaxAngleModel

FLOW = dict(n_blocks=2, n_neurons=8, n_layers=1)


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


class AngleModel(Model):
    """The JAX tests' ``AngleGaussianModel`` on the port's ``Model``."""

    uniform_prior_box = True

    def __init__(self):
        self.names = ["amp", "phi"]
        self.bounds = {"amp": [-5.0, 5.0], "phi": [0.0, 2 * np.pi]}

    log_prior = JaxAngleModel.log_prior
    log_likelihood = JaxAngleModel.log_likelihood

    def torch_log_likelihood(self, x):
        return -0.5 * x[..., 0] ** 2 + torch.cos(x[..., 1])


def _gauss_prior(base):
    """A 2-D model with a Gaussian prior inside its box and no device
    prior, on either package's ``Model``."""

    class GaussPrior(base):
        def __init__(self):
            self.names = ["x_0", "x_1"]
            self.bounds = {"x_0": [-5.0, 5.0], "x_1": [-5.0, 5.0]}

        def log_prior(self, x):
            return np.where(self.in_bounds(x), -0.5 * (np.asarray(x["x_0"]) ** 2 + np.asarray(x["x_1"]) ** 2), -np.inf)

        def log_likelihood(self, x):
            return -0.5 * np.asarray(x["x_0"]) ** 2

    return GaussPrior


def _double(x):
    return 2.0 * x, np.full_like(x, np.log(2.0))


def _halve(x):
    return 0.5 * x, np.full_like(x, -np.log(2.0))


#: configuration -> (models for (JAX, port), proposal keywords, can the loop run)
CONFIGS = {
    "default": ((JaxModel, IntegrationTestModel), {}, True),
    "hypercube": ((JaxModel, IntegrationTestModel), dict(map_to_unit_hypercube=True), False),
    "accept_all": ((JaxModel, IntegrationTestModel), dict(accept_all=True), False),
    "weights": ((JaxModel, IntegrationTestModel), dict(accumulate_weights=True), False),
    "non_radius_rule": (
        (JaxModel, IntegrationTestModel),
        dict(truncation={"latent_radius": {"mode": "constant_volume"}, "min_log_q": {}}),
        False,
    ),
    "likelihood_rule": (
        (JaxModel, IntegrationTestModel),
        dict(truncation={"latent_radius": {"mode": "constant_volume"}, "likelihood_threshold": {}}),
        False,
    ),
    "non_box_prior": ((_gauss_prior(JaxBaseModel), _gauss_prior(Model)), {}, False),
    "no_device_inverse": (
        (JaxModel, IntegrationTestModel),
        dict(reparameterisations={"x_0": {"reparameterisation": "rescaletobounds", "pre_rescaling": (_double, _halve)}}),
        False,
    ),
    "angle_aux_prior": ((JaxAngleModel, AngleModel), dict(reparameterisations={"phi": "angle-2pi"}), True),
}


def _pair(tmp_path, models, seed=3, **kwargs):
    jm, tm = models[0](), models[1]()
    jm.set_rng(np.random.default_rng(seed))
    tm.set_rng(np.random.default_rng(seed))
    common = dict(flow_config=FLOW, training_config=dict(max_epochs=2, batch_size=128), poolsize=200, plot=False)
    jp = JaxFlowProposal(jm, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed + 1), **common, **kwargs)
    tp = FlowProposal(tm, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed + 1), device="cpu",
                      **common, **kwargs)
    jp.initialise()
    tp.initialise()
    return jp, tp


def _use(proposal, mode):
    proposal.populate_mode = mode
    try:
        return proposal._use_device_loop()
    except RuntimeError as e:
        assert "does not support" in str(e)
        return "raises"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_device_loop_eligibility_matches_jax(tmp_path, name):
    """``_can_device_loop``, and ``_use_device_loop`` under each mode, in
    both packages on the same configuration."""
    models, kwargs, expected = CONFIGS[name]
    jp, tp = _pair(tmp_path, models, **kwargs)
    assert tp._can_device_loop is jp._can_device_loop is expected
    for mode in ("auto", "rounds", "device_loop"):
        theirs, ours = _use(jp, mode), _use(tp, mode)
        assert ours == theirs, mode
    assert _use(tp, "rounds") is False
    assert _use(tp, "device_loop") == (True if expected else "raises")


def _box_models(base, prior_hook):
    class PlainUniform(base):
        names = ["x_0", "x_1"]
        bounds = {"x_0": [0.0, 2.0], "x_1": [-3.0, 5.0]}

        def log_prior(self, x):
            log_p = np.log(self.in_bounds(x), dtype="float")
            for b in self.bounds.values():
                log_p -= np.log(b[1] - b[0])
            return log_p

        def log_likelihood(self, x):
            return np.zeros(x.size)

    class GaussPrior(base):
        names = ["x_0", "x_1"]
        bounds = {"x_0": [-5.0, 5.0], "x_1": [-5.0, 5.0]}

        def log_prior(self, x):
            return np.where(self.in_bounds(x), -0.5 * np.asarray(x["x_0"]) ** 2, -np.inf)

        def log_likelihood(self, x):
            return np.zeros(x.size)

    class WithDevicePrior(PlainUniform):
        pass

    setattr(WithDevicePrior, prior_hook, lambda self, x: x[..., 0] * 0.0 - np.log(16.0))
    return PlainUniform, GaussPrior, WithDevicePrior


@pytest.mark.parametrize("case", ["plain_uniform", "gauss_prior", "device_prior", "declared"])
def test_uniform_box_detection_matches_jax(case):
    """The probe finds a plain uniform ``log_prior`` (and caches the
    answer), not a Gaussian one, is skipped where a device prior exists,
    and a declared box needs no probe (``test_device_loop.py:287-360``)."""
    results = []
    for base, hook in ((JaxBaseModel, "jax_log_prior"), (Model, "torch_log_prior")):
        plain, gauss, device_prior = _box_models(base, hook)
        model = {"plain_uniform": plain, "gauss_prior": gauss, "device_prior": device_prior,
                 "declared": type("Declared", (gauss,), {"uniform_prior_box": True})}[case]()
        if case != "declared":
            model.set_rng(np.random.default_rng(0))
        results.append((model.uniform_prior_box, model.has_uniform_box_prior,
                        getattr(model, "_uniform_box_detected", None)))
    assert results[0] == results[1]
    expected = {"plain_uniform": (False, True, True), "gauss_prior": (False, False, False),
                "device_prior": (False, False, None), "declared": (True, True, None)}[case]
    assert results[1] == expected


def _trained_port_proposal(tmp_path, mode, seed=7):
    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(seed))
    model.device = "cpu"
    fp = FlowProposal(model, output=str(tmp_path / mode), poolsize=200, flow_config=FLOW,
                      training_config=dict(max_epochs=5, batch_size=128, patience=3), populate_mode=mode,
                      rng=np.random.default_rng(seed), plot=False, device="cpu")
    fp.initialise()
    x = model.new_point(512)
    x["logL"] = model.batch_evaluate_log_likelihood(x)
    fp.train(x, plot=False)
    return fp, x


def test_device_loop_matches_rounds_distribution(tmp_path):
    """Pools of the two populates from the same weights are draws from one
    distribution (two-sample KS per parameter on pools of 1500)."""
    loop, x = _trained_port_proposal(tmp_path, "device_loop")
    rounds, _ = _trained_port_proposal(tmp_path, "rounds")
    rounds.flow.flow.load_state_dict(loop.flow.flow.state_dict())
    worst = x[np.argmin(x["logL"])]
    before = device_loop_counts.calls
    loop.populate(worst, n_samples=1500)
    assert device_loop_counts.calls > before
    rounds.populate(worst, n_samples=1500)
    assert len(loop.samples) == len(rounds.samples) == 1500
    assert loop.model.in_bounds(loop.samples).all()
    np.testing.assert_allclose(loop.samples["logL"], loop.model.log_likelihood(loop.samples), atol=1e-4, rtol=1e-5)
    for name in loop.model.names:
        assert ks_2samp(loop.samples[name], rounds.samples[name]).pvalue > 0.01, name


class _Script:
    """Each call's accepted count, in order; a call proposes all its
    rounds unless it fills the pool (then one round)."""

    def __init__(self, counts, B, cap):
        self.counts = list(counts)
        self.B, self.cap = B, cap
        self.rounds = []

    def next(self, rounds):
        self.rounds.append(int(rounds))
        count = self.counts[len(self.rounds) - 1]
        n_prop = self.B if count >= self.cap else int(rounds) * self.B
        return count, n_prop


def _scripted(jp, tp, counts, cap):
    """Script the counts into JAX's compiled program (``fm._jit``,
    ``flowproposal.py:879``) and the port's ``_device_loop_call``."""
    B = 1024  # _bucket_size(4 * poolsize)
    n_params = len(tp.parameters)
    scripts = _Script(counts, B, cap), _Script(counts, B, cap)

    def jax_program(*args):
        count, n_prop = scripts[0].next(args[8])
        return np.zeros(cap * n_params + cap, np.float32), np.array([count, n_prop], np.int64)

    jp.flow._jit = lambda key, fn: jax_program

    def port_call(seed, rounds, B_, cap_, r_max, with_ll, first_chunk, scan=None):
        assert (B_, cap_, with_ll, scan) == (B, cap, True, None)
        count, n_prop = scripts[1].next(rounds)
        k = min(count, cap)
        return np.zeros((k, n_params)), np.zeros(k), count, n_prop, None

    tp._device_loop_call = port_call
    return scripts


#: scenario -> (accepted count of each call, pool size, max_samples
#: explicit in the constructor, soft max_samples set afterwards,
#: populate(max_samples=...), the previous populate's acceptance)
SCENARIOS = {
    "soft_budget": ([3, 0, 2, 600], 600, None, 5000, None, None),
    "soft_budget_with_estimate": ([40, 7, 600], 600, None, None, None, 0.01),
    "explicit_cap": ([3, 1], 600, 5000, None, None, None),
    "populate_max_samples": ([3, 1], 600, None, None, 5000, None),
    "shortfall": ([5, 0], 600, 3000, None, None, None),
    "zero_acceptance": ([0, 0], 600, None, 5000, None, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_budget_loop_matches_jax(tmp_path, caplog, name):
    """The host loop around the calls: each call's rounds, the breaks, the
    warnings, the pool, the acceptance, the likelihood count and the host
    stream's state after the populate, the same in both packages."""
    counts, cap, explicit, soft, override, previous = SCENARIOS[name]
    kwargs = {} if explicit is None else dict(max_samples=explicit)
    jp, tp = _pair(tmp_path, (JaxModel, IntegrationTestModel), populate_mode="device_loop", **kwargs)
    train = jp.model.new_point(300)
    outcomes = []
    scripts = _scripted(jp, tp, counts, cap)
    for package, proposal in (("nessai_tpu", jp), ("nessai_tpu_torch", tp)):
        proposal._reparameterisation.update(train)
        if soft is not None:
            proposal.max_samples = soft
        proposal.population_acceptance = previous
        proposal.rng = np.random.default_rng(99)
        evaluations = proposal.model.likelihood_evaluations
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            try:
                proposal.populate(train[0], n_samples=cap, plot=False, max_samples=override)
                result = (len(proposal.samples), proposal.population_acceptance, sorted(proposal.indices))
            except RuntimeError as e:
                result = str(e)
        warnings = [r.getMessage() for r in caplog.records if r.name.split(".")[0] == package]
        outcomes.append(dict(
            result=result,
            warnings=warnings,
            evaluations=proposal.model.likelihood_evaluations - evaluations,
            rng=proposal.rng.bit_generator.state["state"],
            explicit=proposal._max_samples_explicit,
            max_samples=proposal.max_samples,
        ))
    assert scripts[0].rounds == scripts[1].rounds
    assert len(scripts[1].rounds) == len(counts)
    assert outcomes[0] == outcomes[1]
    if name == "populate_max_samples":
        assert outcomes[1]["explicit"] is False and outcomes[1]["max_samples"] == 1_000_000
    if name in ("explicit_cap", "populate_max_samples", "shortfall"):
        assert outcomes[1]["result"][0] < cap and outcomes[1]["warnings"]
    if name == "zero_acceptance":
        assert "0 accepted" in outcomes[1]["result"]


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    """One default run of each package (the device populate loop in the
    flow phase, the prior populated on the device, device stepping)."""
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("runs")
    kwargs = dict(nlive=200, seed=11, resume=False, plot=False, checkpointing=False, maximum_uninformed=150,
                  flow_config=FLOW, training_config=dict(max_epochs=20, batch_size=128, patience=5))
    counts = dict(calls=device_loop_counts.calls, populates=prior_populate_counts.populates)
    fs = FlowSampler(IntegrationTestModel(2), output=str(root / "torch"), device="cpu", **kwargs)
    fs.run(plot=False, save=False)
    counts = dict(calls=device_loop_counts.calls - counts["calls"],
                  populates=prior_populate_counts.populates - counts["populates"])
    jfs = JaxFlowSampler(JaxModel(2), output=str(root / "jax"), **kwargs)
    jfs.run(plot=False, save=False)
    return fs, jfs, counts


def test_end_to_end_device_loop_logz(default_runs):
    """Each package's default run within 3 sigma of the analytic evidence
    and of the other; the port's went through the device populates and
    stepped on the device."""
    fs, jfs, counts = default_runs
    assert fs.ns._flow_proposal._can_device_loop and jfs.ns._flow_proposal._can_device_loop
    assert counts["calls"] > 0 and counts["populates"] > 0
    assert getattr(fs.ns, "_n_device_steps", 0) > 0
    analytic = fs.ns.model.analytic_log_evidence
    t_err, j_err = fs.logZ_error, jfs.logZ_error
    assert abs(fs.logZ - analytic) < 3 * t_err
    assert abs(jfs.logZ - analytic) < 3 * j_err
    assert abs(fs.logZ - jfs.logZ) < 3 * np.hypot(t_err, j_err)


def test_default_run_soft_budget(default_runs):
    """Neither package's default flow proposal sets max_samples, so both
    loops take it as a soft budget."""
    fs, jfs, _ = default_runs
    assert fs.ns._flow_proposal._max_samples_explicit is jfs.ns._flow_proposal._max_samples_explicit is False
    assert fs.ns._flow_proposal.populated_count > 0
