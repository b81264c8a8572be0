"""The standard sampler's options in the port against the JAX package:
the training and reset decisions over a replayed sequence of states, the
iteration cap, the ``t`` shrinkage expectation (the evidence recursion
and the batched consume), the simulated error's draws, the uninformed
and flow proposal options, the examples' keyword arguments, prior
sampling, ``memory``, and small whole runs of both packages."""

import ast
import logging
import pathlib

import numpy as np
import pytest
import torch

from nessai_tpu.evidence import _NSIntegralState as JaxState
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.samplers.nestedsampler import NestedSampler as JaxNestedSampler
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.evidence import _NSIntegralState
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.samplers.nestedsampler import FIXED_OPTIONS, NestedSampler
from nessai_tpu_torch.utils.testing import BimodalGaussianModel, EggboxModel, IntegrationTestModel

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the evidence recursion is float64 host arithmetic in both packages
STATE_RTOL = 1e-12
#: a whole run: both packages within this many standard errors of the
#: analytic evidence and of each other
PULL_LIMIT = 3.0


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


def _pair(tmp_path, **options):
    common = dict(nlive=50, seed=5, plot=False, checkpointing=False)
    jns = JaxNestedSampler(JaxModel(2), output=str(tmp_path / "jax"), **common, **options)
    tns = NestedSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), device="cpu", **common, **options)
    return jns, tns


class _Flow:
    """Records the resets asked of a flow."""

    def __init__(self):
        self.calls = []

    def reset_model(self, weights=True, permutations=False):
        self.calls.append((bool(weights), bool(permutations)))


@pytest.mark.parametrize(
    "options",
    [
        dict(),
        dict(cooldown=50, training_frequency=100, train_on_empty=False),
        dict(retrain_acceptance=False, acceptance_threshold=0.05, cooldown=10, training_frequency="inf"),
        dict(train_on_empty=False, acceptance_threshold=0.1, cooldown=0),
        dict(reset_flow=4),
        dict(reset_weights=3, reset_permutations=5),
        dict(reset_acceptance=True, reset_weights=2, acceptance_threshold=0.05),
        dict(reset_flow=True),
    ],
    ids=str,
)
def test_training_and_reset_decisions_match_jax(tmp_path, options):
    """A recorded sequence of (iteration, block acceptance, populated,
    training count) through both packages' ``check_training`` and
    ``check_flow_model_reset``: the same decisions at every step."""
    jns, tns = _pair(tmp_path, **options)
    rng = np.random.default_rng(11)
    iteration = 0
    for step in range(400):
        iteration += int(rng.integers(0, 120))
        state = dict(
            iteration=iteration,
            mean_block_acceptance=float(rng.choice([0.001, 0.02, 0.2, 0.8])),
            block_iteration=int(rng.integers(0, 400)),
            last_updated=iteration - int(rng.integers(0, 600)),
            completed_training=bool(rng.random() > 0.05),
        )
        populated = bool(rng.random() > 0.5)
        count = int(rng.integers(0, 40))
        decisions = []
        for ns in (jns, tns):
            for k, v in state.items():
                setattr(ns, k, v)
            ns.proposal = ns._flow_proposal
            ns.proposal.populated = populated
            ns._flow_proposal.training_count = count
            ns._flow_proposal.flow = _Flow()
            ns.check_flow_model_reset()
            decisions.append((ns.check_training(), ns._flow_proposal.flow.calls))
        assert decisions[0] == decisions[1], (step, state, populated, count)
    for attr in ("reset_weights", "reset_permutations", "reset_flow", "reset_acceptance", "cooldown",
                 "training_frequency", "train_on_empty", "retrain_acceptance", "acceptance_threshold"):
        assert getattr(tns, attr) == getattr(jns, attr), attr


def test_reset_options_must_be_numbers(tmp_path):
    for cls, model, extra in ((JaxNestedSampler, JaxModel, {}), (NestedSampler, IntegrationTestModel,
                                                                 dict(device="cpu"))):
        for name in ("reset_weights", "reset_permutations", "reset_flow"):
            with pytest.raises(TypeError, match=f"`{name}` must be a bool, int or float"):
                cls(model(2), nlive=50, output=str(tmp_path), **{name: "often"}, **extra)


def test_max_iteration_stops_both_at_the_same_iteration(tmp_path):
    runs = []
    for package in ("jax", "torch"):
        kwargs = dict(output=str(tmp_path / package), nlive=50, seed=2, max_iteration=300, plot=False,
                      checkpointing=False, resume=False)
        if package == "torch":
            fs = FlowSampler(IntegrationTestModel(2), device="cpu", **kwargs)
        else:
            fs = JaxFlowSampler(JaxModel(2), **kwargs)
        _, samples = fs.run(plot=False, save=False)
        runs.append((fs.ns.iteration, len(samples)))
    assert runs[0] == runs[1] == (300, 350)


def _synthetic_run(state, n_nats=20):
    nlive = state.base_nlive
    for i in range(n_nats * nlive):
        state.increment(2.0 * i / nlive)
    for i in range(nlive):
        state.increment(2.0 * n_nats + 1e-3 * (i + 1), nlive=nlive - i)
    state.finalise()
    return state


def test_t_expectation_evidence_matches_jax():
    """``shrinkage_expectation="t"``: the same recursion to 1e-12 (the
    same float64 arithmetic; bit for bit here)."""
    ours = _synthetic_run(_NSIntegralState(100, expectation="t"))
    theirs = _synthetic_run(JaxState(100, expectation="t"))
    np.testing.assert_allclose(ours.logZ, theirs.logZ, rtol=STATE_RTOL)
    np.testing.assert_allclose(ours.info, theirs.info, rtol=STATE_RTOL)
    np.testing.assert_allclose(ours.log_vols, theirs.log_vols, rtol=STATE_RTOL)
    assert ours.logZ != _synthetic_run(_NSIntegralState(100)).logZ
    for package in (_NSIntegralState, JaxState):
        with pytest.raises(ValueError, match="Expectation must be t or logt"):
            package(10, expectation="x")


@pytest.mark.parametrize("seed", [0, 1])
def test_t_expectation_batched_consume_matches_jax(tmp_path, seed):
    """The batched consume under the ``t`` expectation is bit for bit the
    JAX package's."""
    from test_torch_sampler import _live_and_pool, _prime

    common = dict(nlive=50, seed=5, plot=False, checkpointing=False, poolsize=50, shrinkage_expectation="t")
    jns = JaxNestedSampler(JaxModel(2), output=str(tmp_path / "jax"), **common)
    tns = NestedSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), device="cpu", **common)
    live, pool, order = _live_and_pool(tns, seed)
    for ns in (jns, tns):
        _prime(ns, live, pool, order)
        assert ns._consume_from_pool_batched()
    assert tns.iteration == jns.iteration > 0
    for attr in ("logZ", "logw", "oldZ", "logLs", "log_vols", "info"):
        assert getattr(tns.state, attr) == getattr(jns.state, attr), attr


@pytest.mark.parametrize("value, n", [(True, 500), (50, 50), (False, None), (0, None)])
def test_simulated_evidence_error_draws(tmp_path, value, n):
    ns = NestedSampler(IntegrationTestModel(2), nlive=100, output=str(tmp_path), device="cpu", plot=False,
                       checkpointing=False, seed=1, simulated_evidence_error=value)
    _synthetic_run(ns.state)
    ns.rng = np.random.default_rng(4)
    ns.compute_simulated_evidence_error()
    if n is None:
        assert ns.log_evidence_error_simulated is None
    else:
        draws = ns.state.simulate_log_evidence(n, rng=np.random.default_rng(4))
        assert ns.log_evidence_error_simulated == float(np.std(draws))


def test_uninformed_options_match_jax(tmp_path):
    from nessai_tpu_torch.proposal import AnalyticProposal, RejectionProposal

    cases = [
        (dict(), RejectionProposal, 500, 0.5),
        (dict(analytic_priors=True, acceptance_threshold=0.1), AnalyticProposal, 500, 1.0),
        (dict(maximum_uninformed=False, uninformed_acceptance_threshold=0.3), RejectionProposal, 0, 0.3),
        (dict(maximum_uninformed=120, uninformed_proposal=AnalyticProposal,
              uninformed_proposal_kwargs=dict(poolsize=7)), AnalyticProposal, 120, 0.5),
    ]
    for options, cls, max_uninformed, threshold in cases:
        jns, tns = _pair(tmp_path, **options)
        assert type(tns._uninformed_proposal) is cls
        assert type(jns._uninformed_proposal).__name__ == cls.__name__
        assert tns.maximum_uninformed == jns.maximum_uninformed == max_uninformed
        assert tns.uninformed_acceptance_threshold == jns.uninformed_acceptance_threshold == threshold
        assert tns._uninformed_proposal.poolsize == jns._uninformed_proposal.poolsize


def test_flow_proposal_options_match_jax(tmp_path, caplog):
    jns, tns = _pair(tmp_path, flow_class="AugmentedFlowProposal", augment_dims=3, drawsize=40)
    assert type(tns.flow_proposal).__name__ == type(jns.flow_proposal).__name__ == "AugmentedFlowProposal"
    assert tns.flow_proposal.augment_dims == jns.flow_proposal.augment_dims == 3
    assert tns.flow_proposal.drawsize == jns.flow_proposal.drawsize == 40
    # a keyword of another proposal class is dropped with a warning
    with caplog.at_level(logging.WARNING):
        jns, tns = _pair(tmp_path, augment_dims=2, max_n_clusters=4)
    assert type(tns.flow_proposal).__name__ == type(jns.flow_proposal).__name__ == "FlowProposal"
    assert "Removing unused keyword arguments" in caplog.text
    for options, error in (
        (dict(flow_class="flowproposal", flow_proposal_class="flowproposal"), RuntimeError),
        (dict(unknown_option=1), RuntimeError),
        (dict(flow_class="NoSuchProposal"), ValueError),
    ):
        for cls, model, extra in ((JaxNestedSampler, JaxModel, {}), (NestedSampler, IntegrationTestModel,
                                                                     dict(device="cpu"))):
            with pytest.raises(error):
                cls(model(2), nlive=50, output=str(tmp_path), **options, **extra)


@pytest.mark.parametrize("name", ["mcmcflowproposal", "clusteringflowproposal"])
def test_experimental_proposals_name_their_item(tmp_path, name):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 9"):
        NestedSampler(IntegrationTestModel(2), nlive=50, output=str(tmp_path), device="cpu", flow_class=name)


def test_only_the_bookkeeping_options_stay_fixed():
    assert sorted(FIXED_OPTIONS) == ["batched_bookkeeping", "device_bookkeeping"]
    assert {item for _, item in FIXED_OPTIONS.values()} == {"7"}


def _example_kwargs(path, function=None):
    """The keyword arguments of the ``FlowSampler`` call in an example
    file (inside ``function`` where given), without ``output``."""
    tree = ast.parse((ROOT / path).read_text())
    if function is not None:
        tree = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    call = next(
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "FlowSampler"
    )
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords if k.arg != "output"}


@pytest.mark.parametrize(
    "path, function, model",
    [
        ("examples/eggbox.py", None, EggboxModel),
        ("examples/augmented_example.py", None, BimodalGaussianModel),
        ("examples/bilby_example.py", "run_without_bilby", IntegrationTestModel),
    ],
)
def test_examples_construct_a_port_sampler(tmp_path, path, function, model):
    """Each example's keyword arguments, as written, build the port's
    sampler on the CPU, with every option held."""
    kwargs = _example_kwargs(path, function)
    fs = FlowSampler(model(), output=str(tmp_path), device="cpu", **kwargs)
    ns = fs.ns
    if "reset_flow" in kwargs:
        assert ns.reset_weights == ns.reset_permutations == kwargs["reset_flow"]
    if "flow_class" in kwargs:
        assert type(ns.flow_proposal).__name__.lower() == kwargs["flow_class"]
        assert ns.flow_proposal.augment_dims == kwargs["augment_dims"]
    if kwargs.get("analytic_priors"):
        assert type(ns._uninformed_proposal).__name__ == "AnalyticProposal"
    assert ns.nlive == kwargs.get("nlive", 2000) and ns.seed == kwargs["seed"]


def test_prior_sampling_matches_jax(tmp_path):
    results = []
    for package in ("jax", "torch"):
        kwargs = dict(output=str(tmp_path / package), nlive=60, seed=2, prior_sampling=True, plot=False,
                      checkpointing=False, resume=False)
        fs = (FlowSampler(IntegrationTestModel(2), device="cpu", **kwargs) if package == "torch"
              else JaxFlowSampler(JaxModel(2), **kwargs))
        logz, samples = fs.run(plot=False, save=False)
        results.append((logz, len(samples), fs.ns.iteration))
    assert results[0] == results[1] == (-np.inf, 60, 0)


def test_memory_adds_the_last_nested_samples(tmp_path):
    sizes = []
    for ns in _pair(tmp_path, memory=20):
        ns.initialise()
        ns.nested_samples = list(ns.live_points[:30].copy())
        ns._flow_proposal.train = lambda x, plot=True: sizes.append(len(x))
        ns.iteration = 1000
        ns.train_proposal(force=True)
    assert sizes == [70, 70]


def test_small_runs_agree_with_jax(tmp_path):
    """Both packages at nlive 300 with a full reset every 2nd training,
    the adaptive latent radius and the analytic priors: each within 3
    sigma of the analytic evidence and of the other."""
    kwargs = dict(nlive=300, seed=8, plot=False, checkpointing=False, resume=False, reset_flow=2,
                  constant_volume_mode=False, expansion_fraction=0.5, analytic_priors=True,
                  flow_config=dict(n_blocks=2, n_neurons=8), training_config=dict(max_epochs=30, patience=5))
    fs = FlowSampler(IntegrationTestModel(2), output=str(tmp_path / "torch"), device="cpu", **kwargs)
    t_logz, _ = fs.run(plot=False, save=False)
    t_err = fs.logZ_error
    jfs = JaxFlowSampler(JaxModel(2), output=str(tmp_path / "jax"), **kwargs)
    j_logz, _ = jfs.run(plot=False, save=False)
    j_err = jfs.logZ_error
    analytic = -np.log(400.0)
    assert abs(t_logz - analytic) < PULL_LIMIT * t_err
    assert abs(j_logz - analytic) < PULL_LIMIT * j_err
    assert abs(t_logz - j_logz) < PULL_LIMIT * np.hypot(t_err, j_err)
    assert fs.ns.train_count > 2 and fs.ns.flow_proposal.get_truncation_rule("latent_radius").mode == "adaptive"
