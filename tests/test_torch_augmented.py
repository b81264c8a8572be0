"""The port's augmented flow proposal against the JAX package's: the
fixed coupling mask of the 4-D RealNVP, the rescaling with its augment
draws and its inverse, the log-prior with and without the augment prior,
the Monte-Carlo marginal over the augment dimensions through converted
weights, a whole populate from the same weights and generators, and a
small run of each package."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu import config as jax_config
from nessai_tpu.flowsampler import FlowSampler as JaxFlowSampler
from nessai_tpu.model import Model as JaxModelBase
from nessai_tpu.proposal.augmented import AugmentedFlowProposal as JaxAugmented
from nessai_tpu_torch import config
from nessai_tpu_torch.flows import params_from_jax
from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.livepoint import live_points_to_array
from nessai_tpu_torch.proposal.augmented import AugmentedFlowProposal
from nessai_tpu_torch.utils.testing import BimodalGaussianModel

#: host rescalings and priors: float64 numpy in both packages
HOST_RTOL = 1e-12
#: anything through the converted float32 flows
FLOW_ATOL = 1e-5
#: a whole run: within this many standard errors
PULL_LIMIT = 3.0


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _no_extra_live_point_fields():
    """The pools' fields in both packages without the extra live-point
    fields that an importance nested sampler run earlier in the process
    registers (they are global in each package); restored after."""
    saved = [copy.deepcopy(c.livepoints.__dict__) for c in (config, jax_config)]
    for c in (config, jax_config):
        c.livepoints.reset()
    yield
    for c, state in zip((config, jax_config), saved):
        c.livepoints.__dict__.update(state)
        if hasattr(c.livepoints, "reset_properties"):
            c.livepoints.reset_properties()


class JaxBimodal(JaxModelBase):
    """``BimodalGaussianModel`` for the JAX package (the model of
    ``examples/augmented_example.py``)."""

    def __init__(self):
        self.names = ["x", "y"]
        self.bounds = {"x": [-10, 10], "y": [-10, 10]}

    log_prior = BimodalGaussianModel.log_prior
    log_likelihood = BimodalGaussianModel.log_likelihood


def _pair(tmp_path, seed=3, **kwargs):
    """Both proposals from the same generators, the port's flow holding
    the JAX package's (perturbed) weights."""
    common = dict(flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1), poolsize=200, augment_dims=2, **kwargs)
    jmodel, tmodel = JaxBimodal(), BimodalGaussianModel()
    jmodel.set_rng(np.random.default_rng(seed))
    tmodel.set_rng(np.random.default_rng(seed))
    jprop = JaxAugmented(jmodel, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed + 1),
                         populate_mode="rounds", **common)
    tprop = AugmentedFlowProposal(tmodel, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed + 1),
                                  plot=False, device="cpu", **common)
    jprop.initialise()
    tprop.initialise()
    rng = np.random.default_rng(seed + 2)
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.2, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, jprop.flow.params),
    )
    jprop.flow.params = jax.tree.map(jnp.asarray, params)
    params_from_jax(tprop.flow.flow, params)
    train = jmodel.new_point(300)
    jprop._reparameterisation.update(train)
    tprop._reparameterisation.update(train)
    return jprop, tprop, train


def _array(x, names):
    return np.stack([np.asarray(x[n], float) for n in names], axis=1)


def test_spaces_and_mask_match_jax(tmp_path):
    jprop, tprop, _ = _pair(tmp_path)
    assert tprop.parameters == jprop.parameters == ["x", "y", "e_0", "e_1"]
    assert tprop.prime_parameters == jprop.prime_parameters == ["x_prime", "y_prime", "e_0", "e_1"]
    mask = np.asarray(tprop.flow.flow_config.kwargs["mask"])
    np.testing.assert_array_equal(mask, jprop.flow.flow_config.kwargs["mask"])
    np.testing.assert_array_equal(mask, [1, 1, -1, -1])
    couplings = [b for b in tprop.flow.flow.bijector.bijectors if type(b).__name__ == "AffineCoupling"]
    assert [c.transform_idx.tolist() for c in couplings] == [[2, 3], [0, 1]]


@pytest.mark.parametrize("generate", ["gaussian", "zeros"])
def test_rescale_and_inverse_match_jax(tmp_path, generate):
    jprop, tprop, train = _pair(tmp_path, generate_augment=generate)
    x = tprop._convert_to_x(train)
    for compute_radius in (False, True):
        (tp, tlj), (jp, jlj) = (tprop.rescale(x, compute_radius=compute_radius),
                                jprop.rescale(jprop._convert_to_x(train), compute_radius=compute_radius))
        np.testing.assert_allclose(_array(tp, tprop.prime_parameters), _array(jp, jprop.prime_parameters),
                                   rtol=HOST_RTOL, atol=0)
        np.testing.assert_allclose(tlj, jlj, rtol=HOST_RTOL, atol=0)
        (tx, tlj_inv), (jx, jlj_inv) = tprop.inverse_rescale(tp), jprop.inverse_rescale(jp)
        np.testing.assert_allclose(_array(tx, tprop.parameters), _array(jx, jprop.parameters), rtol=HOST_RTOL)
        np.testing.assert_allclose(tlj_inv, jlj_inv, rtol=HOST_RTOL, atol=0)
        np.testing.assert_allclose(_array(tx, ["x", "y"]), _array(train, ["x", "y"]), rtol=1e-10)
    if generate == "zeros":
        assert not np.any(_array(tp, ["e_0", "e_1"]))


@pytest.mark.parametrize("marginalise", [False, True])
def test_log_prior_matches_jax(tmp_path, marginalise):
    jprop, tprop, train = _pair(tmp_path, marginalise_augment=marginalise)
    x = tprop._convert_to_x(train)
    e = np.random.default_rng(0).normal(size=(len(x), 2))
    x["e_0"], x["e_1"] = e[:, 0], e[:, 1]
    np.testing.assert_allclose(tprop.log_prior(x), jprop.log_prior(x.copy()), rtol=HOST_RTOL, atol=0)
    np.testing.assert_allclose(tprop.augmented_prior(x), jprop.augmented_prior(x), rtol=HOST_RTOL, atol=0)


def test_marginalise_augment_matches_jax(tmp_path):
    """The marginal log q of each row's real dimensions: the same augment
    draws (one generator state) through the converted flows, a K1
    forward at [n * n_marg, 4]."""
    jprop, tprop, train = _pair(tmp_path, marginalise_augment=True, n_marg=20)
    x_prime, _ = tprop.rescale(tprop._convert_to_x(train))
    arr = _array(x_prime, tprop.prime_parameters)
    for prop in (jprop, tprop):
        prop.rng = np.random.default_rng(9)
    ours, theirs = tprop._marginalise_augment(arr), jprop._marginalise_augment(arr)
    assert ours.shape == (len(arr),)
    np.testing.assert_allclose(ours, theirs, atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("marginalise", [False, True])
def test_populate_matches_jax_rounds(tmp_path, marginalise):
    """A populate from the same weights and generators: the host inverse
    of the augmented stack in both packages gives the same pool to
    float32 rounding, without the augment columns."""
    jprop, tprop, train = _pair(tmp_path, marginalise_augment=marginalise, n_marg=10)
    jprop.populate(None, n_samples=200)
    tprop.populate(None, n_samples=200)
    assert tprop.samples.size == jprop.samples.size == 200
    assert tprop.population_acceptance == jprop.population_acceptance
    assert tprop.indices == jprop.indices
    assert tprop.samples.dtype.names == jprop.samples.dtype.names
    assert not any(n.startswith("e_") for n in tprop.samples.dtype.names)
    for name in ("x", "y"):
        np.testing.assert_allclose(tprop.samples[name], jprop.samples[name], atol=FLOW_ATOL, rtol=0)
    # the host likelihood of those float32 draws, out to logL of -80
    for name in ("logL", "logP"):
        np.testing.assert_allclose(tprop.samples[name], jprop.samples[name], atol=0, rtol=FLOW_ATOL)
    x = live_points_to_array(tprop.samples, ["x", "y"])
    assert np.all(np.abs(x) <= 10)


def test_small_runs_agree_with_jax(tmp_path):
    """The augmented example at nlive 300 in each package: within 3 sigma
    of -log 400 and of each other."""
    kwargs = dict(nlive=300, seed=1234, plot=False, checkpointing=False, resume=False,
                  flow_class="augmentedflowproposal", augment_dims=2,
                  flow_config=dict(n_blocks=2, n_neurons=8), training_config=dict(max_epochs=30, patience=5))
    fs = FlowSampler(BimodalGaussianModel(), output=str(tmp_path / "torch"), device="cpu", **kwargs)
    t_logz, samples = fs.run(plot=False, save=False)
    jfs = JaxFlowSampler(JaxBimodal(), output=str(tmp_path / "jax"), **kwargs)
    j_logz, _ = jfs.run(plot=False, save=False)
    t_err, j_err = fs.logZ_error, jfs.logZ_error
    analytic = -np.log(400.0)
    assert abs(t_logz - analytic) < PULL_LIMIT * t_err
    assert abs(j_logz - analytic) < PULL_LIMIT * j_err
    assert abs(t_logz - j_logz) < PULL_LIMIT * np.hypot(t_err, j_err)
    assert type(fs.ns.flow_proposal).__name__ == "AugmentedFlowProposal"
    assert not any(n.startswith("e_") for n in samples.dtype.names)
