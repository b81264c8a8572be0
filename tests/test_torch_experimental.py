"""The experimental package of the port against the JAX package's: the
k-means clustering (labels equal on separated blobs from the same
generator, the silhouette score to 1e-12, the choice of k), the
clustering flow model's marginal log-density, each MCMC step's proposals
and log-ratios bit for bit from the same generator, the autocorrelation
helpers to 1e-12, one MCMC populate under converted weights, small whole
runs of both proposals in both packages, and a checkpoint and resume of
each proposal in the port.

Float32 flow outputs are held to atol and rtol 1e-5 (``FLOW_TOL``); the
host arithmetic that both packages do in float64 numpy to 1e-12 or bit
for bit.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.experimental.flowmodel.clustering import ClusteringFlowModel as JaxClusteringFlowModel
from nessai_tpu.experimental.flowmodel.clustering import kmeans as jax_kmeans
from nessai_tpu.experimental.flowmodel.clustering import silhouette_score as jax_silhouette_score
from nessai_tpu.experimental.proposal import MCMCFlowProposal as JaxMCMCFlowProposal
from nessai_tpu.experimental.proposal.mcmc import steps as jax_steps
from nessai_tpu.experimental.proposal.mcmc import utils as jax_mcmc_utils
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.model import Model as JaxBaseModel
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.experimental.flowmodel import ClusteringFlowModel, kmeans, silhouette_score
from nessai_tpu_torch.experimental.proposal import ClusteringFlowProposal, MCMCFlowProposal
from nessai_tpu_torch.experimental.proposal.mcmc import steps, utils as mcmc_utils
from nessai_tpu_torch.flows import params_from_jax
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.utils.testing import GaussianModel, IntegrationTestModel, pickled_types

FLOW_TOL = 1e-5
HOST_TOL = 1e-12
PULL_LIMIT = 3.0
FLOW = dict(n_blocks=2, n_neurons=8, n_layers=1)
TRAIN = dict(max_epochs=50)
#: the examples' runs, cut to nlive 150 and a small flow: the MCMC example
#: (``examples/mcmc_example.py``) and the clustering proposal with the
#: clusters at most
RUNS = {
    "mcmc": dict(flow_class="mcmcflowproposal", n_steps=20, step_type="diff"),
    "clustering": dict(flow_class="clusteringflowproposal", max_clusters=4),
}
COMMON = dict(nlive=150, seed=1234, resume=False, plot=False, flow_config=FLOW, training_config=TRAIN)


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(previous)


class JaxGaussianModel(JaxBaseModel):
    """``examples/mcmc_example.py``'s model on the JAX package's
    ``Model`` (the port's is ``utils.testing.GaussianModel``)."""

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    log_prior = GaussianModel.log_prior
    log_likelihood = GaussianModel.log_likelihood


def _blobs(seed, n=300, centres=((4.0, 4.0), (-4.0, -4.0), (4.0, -4.0))):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    x += np.asarray(centres)[np.arange(n) % len(centres)]
    return x


def _perturb(params, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + rng.normal(0.0, scale, a.shape).astype(a.dtype) if np.asarray(a).dtype.kind == "f" else a,
        jax.tree.map(np.asarray, params),
    )


# ----------------------------------------------------------------------
# Clustering
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 3, 5])
def test_kmeans_and_silhouette_match_jax(k):
    x = _blobs(k)
    ours = kmeans(x, k, rng=np.random.default_rng(7), device="cpu")
    theirs = jax_kmeans(x, k, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_allclose(ours[0], theirs[0], atol=FLOW_TOL, rtol=FLOW_TOL)
    assert ours[0].dtype == np.float32
    score = silhouette_score(x, ours[1])
    assert abs(score - jax_silhouette_score(x, theirs[1])) <= HOST_TOL
    if k == 3:
        assert score > 0.5
    assert silhouette_score(x, np.zeros(len(x), int)) == jax_silhouette_score(x, np.zeros(len(x), int)) == -1.0


def _clustering_models(tmp_path, max_clusters=4):
    jfm = JaxClusteringFlowModel(dict(n_inputs=2, **FLOW), output=str(tmp_path / "jax"),
                                 rng=np.random.default_rng(3), max_clusters=max_clusters)
    tfm = ClusteringFlowModel(dict(n_inputs=2, **FLOW), output=str(tmp_path / "torch"),
                              rng=np.random.default_rng(3), max_clusters=max_clusters, device="cpu")
    jfm.initialise()
    tfm.initialise()
    params = _perturb(jfm.params, 4)
    jfm.params = jax.tree.map(jnp.asarray, params)
    params_from_jax(tfm.flow, params)
    return jfm, tfm


def test_train_clustering_and_marginal_log_prob_match_jax(tmp_path):
    """The same k, labels and weights from the same generator, the same
    one-hot conditional, and the marginal log-density over the labels
    (the port's one batched pass against the JAX package's pass a label)
    to float32 tolerance."""
    jfm, tfm = _clustering_models(tmp_path)
    x = _blobs(1, n=200)
    c_t = tfm.train_clustering(x)
    c_j = jfm.train_clustering(x)
    assert tfm.n_clusters == jfm.n_clusters == 3
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(tfm.cluster_weights, jfm.cluster_weights)
    np.testing.assert_allclose(tfm.cluster_centres, jfm.cluster_centres, atol=FLOW_TOL, rtol=FLOW_TOL)
    assert c_t.shape == (200, 4) and c_t.dtype == np.float32
    np.testing.assert_array_equal(tfm.assign_labels(x), jfm.assign_labels(x))
    np.testing.assert_array_equal(tfm.get_cluster_labels(x[:5]), jfm.get_cluster_labels(x[:5]))
    np.testing.assert_array_equal(tfm.get_cluster_labels(x[:5], clusterer=tfm.cluster_centres[::-1]),
                                  jfm.get_cluster_labels(x[:5], clusterer=jfm.cluster_centres[::-1]))
    z = np.random.default_rng(5).normal(size=(64, 2)) * 3
    np.testing.assert_allclose(tfm.log_prob_marginalised(z), jfm.log_prob_marginalised(z),
                               atol=FLOW_TOL, rtol=FLOW_TOL)
    # the draws of labels take the same numbers from the shared generator
    np.testing.assert_array_equal(tfm.sample_labels(30), jfm.sample_labels(30))
    np.testing.assert_array_equal(tfm.sample_cluster_labels(30), jfm.sample_cluster_labels(30))
    for conditional in (c_t, None):
        tfm.train(x, conditional=conditional, max_epochs=2, save=False)
    # a model of one cluster: fewer samples than two clusters need
    tfm.train_clustering(x[:2])
    assert tfm.n_clusters == 1 and np.array_equal(tfm.cluster_weights, [1.0])


def test_clustering_flow_model_pickles_without_device_objects(tmp_path):
    _, tfm = _clustering_models(tmp_path)
    tfm.train_clustering(_blobs(2, n=100))
    found = pickled_types(tfm)
    assert not any(isinstance(o, torch.nn.Module) for o in found)
    assert all(o.device.type == "cpu" for o in found if isinstance(o, torch.Tensor))
    back = pickle.loads(pickle.dumps(tfm))
    assert back.n_clusters == tfm.n_clusters and back.max_clusters == 4
    np.testing.assert_array_equal(back.cluster_weights, tfm.cluster_weights)


# ----------------------------------------------------------------------
# MCMC
# ----------------------------------------------------------------------
STEPS = [
    ("gaussian", dict()),
    ("gaussian", dict(scale=0.3)),
    ("diff", dict()),
    ("diff", dict(mix_fraction=0.2, sigma=0.1)),
    ("stretch", dict()),
    ("stretch", dict(a=1.5)),
]


@pytest.mark.parametrize("with_ensemble", [False, True])
@pytest.mark.parametrize("name,kwargs", STEPS)
def test_mcmc_steps_match_jax_bit_for_bit(name, kwargs, with_ensemble):
    """Each step's proposals and log-ratios, and its adaptation, equal to
    the JAX package's from the same generator."""
    z = np.random.default_rng(1).normal(size=(50, 3))
    ensemble = np.random.default_rng(2).normal(size=(20, 3)) if with_ensemble else None
    ours = steps.KNOWN_STEPS[name](3, ensemble=ensemble, rng=np.random.default_rng(3), **kwargs)
    theirs = jax_steps.KNOWN_STEPS[name](3, ensemble=ensemble, rng=np.random.default_rng(3), **kwargs)
    for _ in range(3):
        a, b = ours(z), theirs(z)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        ours.update_stats(7, 13)
        theirs.update_stats(7, 13)
        assert ours.scale == theirs.scale if name != "diff" else ours.g0 == theirs.g0
        z = a[0]
    assert steps.Step is steps.MCMCStep
    assert set(steps.KNOWN_STEPS) == set(jax_steps.KNOWN_STEPS)


def test_autocorrelation_helpers_match_jax():
    rng = np.random.default_rng(4)
    chain = np.zeros((2000, 6, 2))
    eps = rng.standard_normal(chain.shape)
    for t in range(1, len(chain)):
        chain[t] = 0.8 * chain[t - 1] + eps[t]
    assert [mcmc_utils.next_pow_two(n) for n in (0, 1, 2, 3, 5, 1000)] == [
        jax_mcmc_utils.next_pow_two(n) for n in (0, 1, 2, 3, 5, 1000)]
    np.testing.assert_allclose(mcmc_utils.function_1d(chain[:, 0, 0]), jax_mcmc_utils.function_1d(chain[:, 0, 0]),
                               rtol=HOST_TOL, atol=HOST_TOL)
    tau = mcmc_utils.integrated_time(chain)
    np.testing.assert_allclose(tau, jax_mcmc_utils.integrated_time(chain), rtol=HOST_TOL, atol=HOST_TOL)
    np.testing.assert_allclose(tau, (1 + 0.8) / (1 - 0.8), rtol=0.3)
    taus = np.linspace(1, 3, 40)
    assert mcmc_utils.auto_window(taus, 5) == jax_mcmc_utils.auto_window(taus, 5)
    for bad, fn in ((np.zeros((4, 4)), mcmc_utils.function_1d), (np.zeros((10, 2)), mcmc_utils.integrated_time)):
        with pytest.raises(ValueError):
            fn(bad)


def _mcmc_pair(tmp_path):
    """Both packages' MCMC proposals with the same fitted
    reparameterisations, converted weights and training data."""
    common = dict(poolsize=100, n_steps=5, step_type="diff", flow_config=FLOW, plot=False)
    jmodel, tmodel = JaxGaussianModel(), GaussianModel()
    jmodel.set_rng(np.random.default_rng(0))
    tmodel.set_rng(np.random.default_rng(0))
    jp = JaxMCMCFlowProposal(jmodel, output=str(tmp_path / "jax"), rng=np.random.default_rng(0), **common)
    tp = MCMCFlowProposal(tmodel, output=str(tmp_path / "torch"), rng=np.random.default_rng(0), device="cpu",
                          **common)
    jp.initialise()
    tp.initialise()
    x = tmodel.new_point(200)
    jx = jmodel.new_point(200)
    for name in tmodel.names:
        jx[name] = x[name]
    for p, pts in ((jp, jx), (tp, x)):
        pts["logL"] = p.model.batch_evaluate_log_likelihood(pts)
        pts = p._convert_to_x(pts)
        p.training_data = pts.copy()
        p._reparameterisation.update(pts)
    params = _perturb(jp.flow.params, 6, scale=0.1)
    jp.flow.params = jax.tree.map(jnp.asarray, params)
    params_from_jax(tp.flow.flow, params)
    return jp, tp, jx[np.argsort(jx["logL"])[50]]


def _jax_latent_target(proposal):
    """Give the JAX package's proposal the port's latent target: its
    ``_backward_nofilter`` returns ``log q(x)``, and the acceptance is by
    ``p(x) / q(x)``; with ``log q(x) - log q_z(z)`` in its place, it is by
    ``p(x) |dx/dz|`` (ROADMAP §3)."""
    real = proposal._backward_nofilter

    def latent(z):
        x, log_q = real(z)
        return x, log_q - (-0.5 * np.sum(z**2, axis=1) - 0.5 * z.shape[1] * np.log(2 * np.pi))

    proposal._backward_nofilter = latent


def test_mcmc_populate_matches_jax(tmp_path):
    """One populate of both packages' MCMC proposals from the same
    generator, the JAX package's given the port's latent target: the
    same pool (float32 tolerance), likelihoods, acceptance and pop order.
    Every accept decision is the same here; a float32 difference that
    flipped one would part that walker's chain from the JAX package's."""
    jp, tp, worst = _mcmc_pair(tmp_path)
    _jax_latent_target(jp)
    for p in (jp, tp):
        # the proposal, its step and its flow model share this generator
        p.rng.bit_generator.state = np.random.default_rng(9).bit_generator.state
        p.populate(worst, n_samples=100)
    for name in ("x", "y", "logL", "logP"):
        np.testing.assert_allclose(tp.samples[name], jp.samples[name], atol=FLOW_TOL, rtol=FLOW_TOL)
    assert tp.indices == jp.indices
    assert tp.mcmc_history == jp.mcmc_history
    assert 0 < tp.population_acceptance < 1
    # a walker that accepted no move keeps its start, whatever its likelihood
    assert tp.model.in_bounds(tp.samples).all() and (tp.samples["logL"] > worst["logL"]).mean() > 0.5


def test_mcmc_target_is_the_latent_prior(tmp_path):
    """The deliberate difference: the JAX package's acceptance by ``p(x)
    / q(x)`` gives another chain from the same numbers; the port's
    ``log|dx/dz|`` is ``log q_z(z) - log q(x)`` of the same walkers."""
    jp, tp, worst = _mcmc_pair(tmp_path)
    z = np.random.default_rng(3).normal(size=(64, 2))
    x_t, log_j = tp._latent_to_x(z)
    x_j, log_q = jp._backward_nofilter(z)
    log_base = -0.5 * np.sum(z**2, axis=1) - np.log(2 * np.pi)
    np.testing.assert_allclose(log_j, log_base - log_q, atol=FLOW_TOL, rtol=FLOW_TOL)
    for p in (jp, tp):
        p.rng.bit_generator.state = np.random.default_rng(9).bit_generator.state
        p.populate(worst, n_samples=100)
    assert not np.allclose(tp.samples["x"], jp.samples["x"])


# ----------------------------------------------------------------------
# Whole runs, checkpoint and resume
# ----------------------------------------------------------------------
def _record_checkpoints(records):
    def callback(sampler):
        records.append(pickle.dumps(sampler))

    return callback


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each proposal's run in both packages at nlive 150; the port's
    keeps its checkpoints (one after each training)."""
    out = {}
    for name, options in RUNS.items():
        records = []
        port = FlowSampler(
            GaussianModel() if name == "mcmc" else IntegrationTestModel(2),
            output=str(tmp_path_factory.mktemp(f"torch_{name}")), device="cpu", signal_handling=False,
            checkpoint_on_training=True, checkpoint_callback=_record_checkpoints(records), **COMMON, **options,
        )
        port.run(plot=False, save=False)
        jax_run = JaxFlowSampler(
            JaxGaussianModel() if name == "mcmc" else JaxModel(2), output=str(tmp_path_factory.mktemp(f"jax_{name}")),
            checkpointing=False, **COMMON, **options,
        )
        # the JAX clustering proposal plots every training's loss whatever
        # the sampler's plot option (its train calls FlowModel.train with
        # plot=True); the plots are not under test and cost most of its run
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr("nessai_tpu.plot.plot_loss", lambda *args, **kwargs: None)
            jax_run.run(plot=False, save=False)
        out[name] = (port, jax_run, records)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_agree_with_the_analytic_evidence_and_jax(runs, name):
    """Each run's evidence within 3 sigma of the analytic value and of
    the other package's. The JAX package's MCMC run is held to the
    port's alone: its acceptance leaves out the latent base density
    (ROADMAP §3), and its evidence falls short by several standard errors
    at nlive 2000 (3 at this seed at nlive 150)."""
    port, jax_run, _ = runs[name]
    analytic = -np.log(400.0)
    for fs in (port, jax_run) if name == "clustering" else (port,):
        assert abs(fs.logZ - analytic) < PULL_LIMIT * fs.logZ_error, (fs.logZ, fs.logZ_error)
    assert abs(port.logZ - jax_run.logZ) < PULL_LIMIT * np.hypot(port.logZ_error, jax_run.logZ_error)
    proposal = port.ns.flow_proposal
    assert type(proposal).__name__ == type(jax_run.ns.flow_proposal).__name__
    assert port.ns.train_count >= 2
    if name == "mcmc":
        assert proposal.mcmc_history["n_steps"] == [20] * proposal.populated_count
        assert all(0 < a < 1 for a in proposal.mcmc_history["acceptance"])
    else:
        assert 2 <= proposal.flow.n_clusters <= 8
        np.testing.assert_allclose(proposal.flow.cluster_weights.sum(), 1.0)


@pytest.mark.parametrize("name", list(RUNS))
def test_checkpoint_and_resume(runs, name, tmp_path):
    """The last checkpoint before the end, written to the resume file,
    resumes through ``FlowSampler(..., resume=True)`` with the proposal's
    own state (the MCMC history and step; the clustering, which the JAX
    package's pickle leaves out) and runs to an evidence within 3 sigma
    of the analytic value."""
    port, _, records = runs[name]
    data = records[-2]
    saved = pickle.loads(data)
    with open(os.path.join(tmp_path, "nested_sampler_resume.pkl"), "wb") as f:
        f.write(data)
    model = GaussianModel() if name == "mcmc" else IntegrationTestModel(2)
    fs = FlowSampler(model, output=str(tmp_path), device="cpu", signal_handling=False,
                     **dict(COMMON, resume=True), **RUNS[name])
    proposal = fs.ns.flow_proposal
    assert fs.ns.iteration == saved.iteration < port.ns.iteration
    if name == "mcmc":
        assert proposal.mcmc_history == saved._flow_proposal.mcmc_history
        assert proposal._step.rng is proposal.rng
    else:
        n_clusters, centres, weights = saved._flow_proposal._clusters
        assert proposal.flow.n_clusters == n_clusters >= 2
        np.testing.assert_array_equal(proposal.flow.cluster_weights, weights)
        np.testing.assert_array_equal(proposal.flow.cluster_centres, centres)
    fs.run(plot=False, save=False)
    assert abs(fs.logZ + np.log(400.0)) < PULL_LIMIT * fs.logZ_error


def test_clustering_populate_takes_neither_the_device_loop_nor_the_fused_call(runs):
    """The clustering proposal has no device inverse, as in the JAX
    package: its populates take the rounds through ``backward_pass``."""
    proposal = runs["clustering"][0].ns.flow_proposal
    assert isinstance(proposal, ClusteringFlowProposal)
    assert not proposal.uses_device_inverse and not proposal._can_device_loop
    assert proposal.populated_count >= 2
