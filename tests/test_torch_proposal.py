"""The port's proposal stack against the JAX package's: the z-score
reparameterisation, the latent radius, and a whole populate from the
same weights and the same host RNG seed (the JAX package's ``rounds``
populate draws its latents and acceptance uniforms with the same numpy
generator, so the pools agree up to float32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.proposal.flowproposal import FlowProposal as JaxFlowProposal
from nessai_tpu.proposal.flowproposal.truncation import (
    LatentRadiusTruncation as JaxLatentRadius,
)
from nessai_tpu.reparameterisations import get_reparameterisation as jax_get_reparam
from nessai_tpu.utils.sampling import NDimensionalTruncatedGaussian as JaxTruncGauss
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.flows import params_from_jax
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.proposal.flowproposal import FlowProposal
from nessai_tpu_torch.proposal.flowproposal.truncation import LatentRadiusTruncation
from nessai_tpu_torch.reparameterisations import get_reparameterisation
from nessai_tpu_torch.utils.sampling import NDimensionalTruncatedGaussian
from nessai_tpu_torch.utils.testing import IntegrationTestModel

NAMES = ["x_0", "x_1", "x_2"]


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


def _points(n, seed, dims=3):
    arr = np.random.default_rng(seed).normal([1.0, -2.0, 0.5][:dims], [2.0, 0.5, 3.0][:dims], (n, dims))
    return numpy_array_to_live_points(arr, NAMES[:dims])


def _zscore(module_get):
    cls, kwargs = module_get("zscore")
    bounds = {n: np.array([-10.0, 10.0]) for n in NAMES}
    return cls(parameters=list(NAMES), prior_bounds=bounds, **kwargs)


def test_zscore_matches_jax():
    ours, theirs = _zscore(get_reparameterisation), _zscore(jax_get_reparam)
    train = _points(500, 1)
    ours.update(train)
    theirs.update(train)
    x = _points(200, 2)
    dtype = np.dtype([(f"{n}_prime", "f8") for n in NAMES])
    out = []
    for r in (ours, theirs):
        xp = np.zeros(len(x), dtype=dtype)
        _, xp, lj = r.reparameterise(x.copy(), xp, np.zeros(len(x)))
        back = x.copy()
        for n in NAMES:
            back[n] = np.nan
        back, _, lj_inv = r.inverse_reparameterise(back, xp, np.zeros(len(x)))
        out.append((xp, lj, back, lj_inv))
    for a, b in zip(*out):
        for name in a.dtype.names or [None]:
            va = a[name] if name else a
            vb = b[name] if name else b
            np.testing.assert_allclose(va, vb, atol=1e-10, rtol=0)
    np.testing.assert_allclose(out[0][2]["x_1"], x["x_1"], atol=1e-10)


def test_zscore_device_inverse_matches_jax():
    ours, theirs = _zscore(get_reparameterisation), _zscore(jax_get_reparam)
    train = _points(500, 3)
    ours.update(train)
    theirs.update(train)
    cols = {f"{n}_prime": np.random.default_rng(4).normal(size=64).astype(np.float32) for n in NAMES}
    upd_t, lj_t = ours.torch_inverse({k: torch.as_tensor(v) for k, v in cols.items()})
    fn, _ = theirs.jax_inverse()
    upd_j, lj_j = fn({k: jnp.asarray(v) for k, v in cols.items()}, theirs.jax_inverse_consts())
    for n in NAMES:
        np.testing.assert_allclose(upd_t[n].numpy(), np.asarray(upd_j[n]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(lj_t), float(lj_j), atol=1e-6)


class _Stub:
    def __init__(self, dims, seed):
        self.prime_dims = dims
        self.rng = np.random.default_rng(seed)
        self.r = None


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("dims", [1, 2, 3, 5, 8])
def test_latent_radius_matches_jax(dims, seed):
    """The flow proposal's default truncation: JAX's ``latent_radius``
    rule in ``constant_volume`` mode with q = 0.95."""
    ours = LatentRadiusTruncation(mode="constant_volume", q=0.95)
    theirs = JaxLatentRadius(mode="constant_volume", q=0.95)
    a, b = _Stub(dims, seed), _Stub(dims, seed)
    ours.prepare(a, None)
    theirs.prepare(b, None)
    assert ours.r == theirs.r == a.r == b.r
    z = ours.sample_latent(a, 100)
    np.testing.assert_array_equal(z, theirs.sample_latent(b, 100))
    np.testing.assert_array_equal(ours.apply_latent(a, 1.2 * z), theirs.apply_latent(b, 1.2 * z))


def test_truncated_gaussian_matches_jax():
    ours = NDimensionalTruncatedGaussian(3, 2.0, rng=np.random.default_rng(9))
    theirs = JaxTruncGauss(3, 2.0, rng=np.random.default_rng(9))
    a, b = ours.sample(1000), theirs.sample(1000)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.linalg.norm(a, axis=1) <= 2.0 + 1e-12)


def _proposals(tmp_path, dims=2, seed=17):
    flow_config = dict(n_blocks=2, n_neurons=4, n_layers=1)
    jmodel, tmodel = JaxModel(dims), IntegrationTestModel(dims)
    jmodel.set_rng(np.random.default_rng(seed))
    tmodel.set_rng(np.random.default_rng(seed))
    tmodel.device = "cpu"
    jprop = JaxFlowProposal(
        jmodel,
        flow_config=flow_config,
        output=str(tmp_path / "jax"),
        poolsize=400,
        rng=np.random.default_rng(seed + 1),
        populate_mode="rounds",
        fuse_likelihood=True,
    )
    tprop = FlowProposal(
        tmodel,
        flow_config=flow_config,
        output=str(tmp_path / "torch"),
        poolsize=400,
        rng=np.random.default_rng(seed + 1),
        plot=False,
        device="cpu",
    )
    jprop.initialise()
    tprop.initialise()
    rng = np.random.default_rng(seed + 2)
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.2, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, jprop.flow.params),
    )
    jprop.flow.params = jax.tree.map(jnp.asarray, params)
    params_from_jax(tprop.flow.flow, params)
    # a training set of unit width keeps |logL| of order ten, where
    # float32 rounding stays well inside the 1e-5 tolerance
    train = jmodel.new_point(300)
    for i, name in enumerate(jmodel.names):
        train[name] = 0.1 * train[name] + 0.3 * i
    jprop._reparameterisation.update(train)
    tprop._reparameterisation.update(train)
    return jprop, tprop


def test_populate_matches_jax_rounds(tmp_path):
    jprop, tprop = _proposals(tmp_path)
    for _ in range(2):
        jprop.populate(None, n_samples=400)
        tprop.populate(None, n_samples=400)
        assert tprop.samples.size == jprop.samples.size == 400
        assert tprop.population_acceptance == jprop.population_acceptance
        assert tprop.indices == jprop.indices
        for name in ("x_0", "x_1", "logL", "logP"):
            np.testing.assert_allclose(
                tprop.samples[name], jprop.samples[name], atol=1e-5, rtol=0
            )
        assert tprop.model.likelihood_evaluations == jprop.model.likelihood_evaluations
        assert tprop.samples["logL"].dtype == np.float64


def test_populate_draws_through_the_coupling_wrapper(tmp_path, monkeypatch):
    from nessai_tpu_torch.flows import bijectors

    calls = []
    real = bijectors.affine_coupling_layer

    def spy(x, out, transform_idx, inverse=False, clamp=5.0):
        calls.append((tuple(x.shape), inverse))
        return real(x, out, transform_idx, inverse, clamp)

    monkeypatch.setattr(bijectors, "affine_coupling_layer", spy)
    _, tprop = _proposals(tmp_path)
    tprop.populate(None, n_samples=200)
    assert calls and all(inverse for _, inverse in calls)
    assert len(calls) % 2 == 0  # two couplings per flow inverse


def test_populate_without_device_likelihood(tmp_path):
    """A model with only a host ``log_likelihood``: the fused call skips
    the likelihood and the accepted pool is evaluated on the host."""
    model = IntegrationTestModel(2)
    model.torch_log_likelihood = None
    model.set_rng(np.random.default_rng(2))
    prop = FlowProposal(
        model,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
        output=str(tmp_path),
        poolsize=100,
        rng=np.random.default_rng(3),
        plot=False,
        device="cpu",
    )
    prop.initialise()
    prop.populate(None, n_samples=100)
    assert prop.samples.size == 100
    np.testing.assert_array_equal(prop.samples["logL"], model.log_likelihood(prop.samples))
    assert model.likelihood_evaluations == 100


@pytest.mark.parametrize(
    "spec,primes",
    [
        (None, ["x_0_prime", "x_1_prime"]),
        ("zscore", ["x_0_prime", "x_1_prime"]),
        ("none", ["x_0", "x_1"]),
        ({"x_1": "none"}, ["x_0_prime", "x_1"]),
    ],
)
def test_reparameterisation_specs(tmp_path, spec, primes):
    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(1))
    prop = FlowProposal(
        model, output=str(tmp_path), reparameterisations=spec, device="cpu"
    )
    prop.set_rescaling()
    assert sorted(prop.prime_parameters) == primes
    prop.verify_rescaling()
    with pytest.raises(RuntimeError, match="y is not a parameter in the model or a known reparameterisation"):
        FlowProposal(
            model, output=str(tmp_path), reparameterisations={"y": "zscore"}, device="cpu"
        ).set_rescaling()


def test_analytic_proposal_draws_from_the_prior():
    from nessai_tpu_torch.proposal import AnalyticProposal

    model = IntegrationTestModel(2)
    model.set_rng(np.random.default_rng(4))
    model.device = "cpu"
    prop = AnalyticProposal(model, rng=np.random.default_rng(5), poolsize=64)
    drawn = [prop.draw(None) for _ in range(64)]
    assert not prop.populated
    x = np.array([[d["x_0"], d["x_1"]] for d in drawn])
    assert np.all(np.abs(x) <= 10.0)
    np.testing.assert_allclose(
        [d["logL"] for d in drawn], -0.5 * np.sum(x**2, axis=1) - np.log(2 * np.pi), atol=1e-5
    )
    assert model.likelihood_evaluations == 64
