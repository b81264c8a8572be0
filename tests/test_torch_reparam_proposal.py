"""The port's flow proposal through the reparameterisations, against the
JAX package's: the stack that every spec form builds, and the device
call of the populate (flow inverse, inverse reparameterisation, bounds)
on the same latent draws through converted flow weights, for the spec of
each of the four reparameterisation examples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from reparam_examples import SPECS, example_models

import nessai_tpu.livepoint as jax_livepoint
from nessai_tpu.model import Model as JaxModelBase
from nessai_tpu.proposal.flowproposal import FlowProposal as JaxFlowProposal
from nessai_tpu_torch import livepoint
from nessai_tpu_torch.flows import params_from_jax
from nessai_tpu_torch.model import Model
from nessai_tpu_torch.proposal.flowproposal import FlowProposal

TORCH_MODELS = example_models(Model, livepoint.empty_structured_array, livepoint.numpy_array_to_live_points)
JAX_MODELS = example_models(
    JaxModelBase, jax_livepoint.empty_structured_array, jax_livepoint.numpy_array_to_live_points
)
FLOW_CONFIG = dict(n_blocks=2, n_neurons=4, n_layers=1)
#: float32 tolerance of the device call, as the JAX package's own fused
#: populate test holds it against the host
TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


def _sky(base):
    class SkyModel(base):
        def __init__(self):
            self.names = ["ra", "dec", "q_0", "q_1"]
            self.bounds = {"ra": [0.0, 2 * np.pi], "dec": [-np.pi / 2, np.pi / 2], "q_0": [-1.0, 1.0],
                           "q_1": [0.0, 3.0]}

        def log_prior(self, x):
            with np.errstate(divide="ignore"):
                lp = np.log(self.in_bounds(x), dtype=float)
            for n in self.names:
                lp -= np.log(np.ptp(self.bounds[n]))
            return lp

        def log_likelihood(self, x):
            return np.zeros(len(np.atleast_1d(x)))

    return SkyModel()


#: every spec form of the JAX package's configure tests, with the
#: proposal options beside it
STACK_SPECS = [
    (None, {}),
    ("rescaletobounds", {}),
    ("inversion", {}),
    ({"q_0": "zscore", "q_1": "rescaletobounds"}, {}),
    ({"q_0": {"reparameterisation": "rescaletobounds", "rescale_bounds": [0.0, 1.0]}}, {}),
    ({"q_0": {"reparameterisation": "default", "prior": "uniform", "update_bounds": False}}, {}),
    ({"q_.*": "zscore"}, {}),
    ({"zscore": {"parameters": ["q_0", "q_1"]}}, {}),
    ({"rescaletobounds": ["q_0", "q_1"]}, {}),
    ({"sky": {"reparameterisation": "angle-pair", "parameters": ["ra", "dec"]}}, {}),
    ({"ra": "angle-2pi", "q_1": "inversion-duplicate"}, {}),
    ({"q_0": "none"}, {}),
    ({"q_0": None, "q_1": "logit"}, {}),
    ({"q_0": "zscore"}, dict(fallback_reparameterisation=None)),
    ({"q_0": "logit", "q_1": "default"}, dict(reverse_reparameterisations=True)),
    ({"q_0": "logit"}, dict(fallback_reparameterisation="default", use_default_reparameterisations=True)),
]


def _stack(prop):
    stack = prop._reparameterisation
    return (
        [(k, type(r).__name__, r.parameters, r.prime_parameters, r.auxiliary_parameters) for k, r in stack.items()],
        stack.to_prime_order,
        prop.parameters,
        prop.prime_parameters,
        prop.use_x_prime_prior,
    )


@pytest.mark.parametrize("spec, options", STACK_SPECS, ids=[str(i) for i in range(len(STACK_SPECS))])
def test_spec_forms_build_the_jax_stack(tmp_path, spec, options):
    props = []
    for base, cls, kwargs in (
        (Model, FlowProposal, dict(device="cpu")),
        (JaxModelBase, JaxFlowProposal, dict(plot=False)),
    ):
        model = _sky(base)
        model.set_rng(np.random.default_rng(1))
        prop = cls(model, output=str(tmp_path / cls.__module__), rng=np.random.default_rng(2),
                   reparameterisations=spec, flow_config=FLOW_CONFIG, **options, **kwargs)
        prop.set_rescaling()
        prop.verify_rescaling()
        props.append(prop)
    assert _stack(props[0]) == _stack(props[1])


@pytest.mark.parametrize(
    "spec, match",
    [
        ({"zscore": {}}, "parameters"),
        ({"widget": {"parameters": ["q_0"]}}, "not a parameter in the model or a known reparameterisation"),
        ({"q_0": {"scale": 2.0}}, "No reparameterisation found for q_0"),
    ],
)
def test_spec_errors_match_jax(tmp_path, spec, match):
    for base, cls, kwargs in ((Model, FlowProposal, dict(device="cpu")), (JaxModelBase, JaxFlowProposal, {})):
        prop = cls(_sky(base), output=str(tmp_path), reparameterisations=spec, **kwargs)
        with pytest.raises(RuntimeError, match=match):
            prop.configure_reparameterisations(spec)


def _proposals(tmp_path, example, seed=31):
    jmodel, tmodel = JAX_MODELS[example](), TORCH_MODELS[example]()
    jmodel.set_rng(np.random.default_rng(seed))
    tmodel.set_rng(np.random.default_rng(seed))
    common = dict(flow_config=FLOW_CONFIG, poolsize=200, rng=np.random.default_rng(seed + 1),
                  reparameterisations=SPECS[example])
    jprop = JaxFlowProposal(jmodel, output=str(tmp_path / "jax"), populate_mode="rounds", plot=False, **common)
    tprop = FlowProposal(tmodel, output=str(tmp_path / "torch"), plot=False, device="cpu", **common)
    jprop.initialise()
    tprop.initialise()
    rng = np.random.default_rng(seed + 2)
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.2, a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        jax.tree.map(np.asarray, jprop.flow.params),
    )
    jprop.flow.params = jax.tree.map(jnp.asarray, params)
    params_from_jax(tprop.flow.flow, params)
    # the stacks fitted to one training set, edges detected and radii
    # drawn as a training does
    train = jmodel.new_point(500)
    for prop in (jprop, tprop):
        x = prop._convert_to_x(train.copy())
        prop._reparameterisation.update(x)
        prop.rescale(x)
    return jprop, tprop


@pytest.mark.parametrize("example", list(SPECS))
def test_device_call_matches_jax(tmp_path, example):
    """The same latent draws through both packages' populate device call:
    x (auxiliary columns included), log q and the in-bounds mask."""
    jprop, tprop = _proposals(tmp_path, example)
    assert jprop._device_inverse is not None
    assert tprop.parameters == jprop.parameters and tprop.prime_parameters == jprop.prime_parameters
    assert {k: getattr(r, "_edges", None) for k, r in tprop._reparameterisation.items()} == {
        k: getattr(r, "_edges", None) for k, r in jprop._reparameterisation.items()
    }
    z = np.random.default_rng(3).normal(0, 1, (2000, len(tprop.prime_parameters)))
    z = z[np.linalg.norm(z, axis=1) < 3.0]
    x_t, log_q_t, _, in_t = tprop._fused_backward(z, with_likelihood=False)
    x_j, log_q_j, _, in_j = jprop._fused_backward(z, with_likelihood=False)
    np.testing.assert_array_equal(in_t, in_j)
    assert in_t.any() and (example == "unbounded_prior" or not in_t.all())
    np.testing.assert_allclose(x_t, x_j, atol=TOL, rtol=TOL)
    finite = np.isfinite(log_q_j)
    np.testing.assert_array_equal(np.isfinite(log_q_t), finite)
    np.testing.assert_allclose(log_q_t[finite], log_q_j[finite], atol=TOL, rtol=TOL)
    if example == "angle":
        assert tprop.parameters == ["theta", "amp", "theta_radial"]
        assert np.all((x_t[in_t, 0] >= 0) & (x_t[in_t, 0] <= 2 * np.pi))
    if example == "discrete":
        np.testing.assert_array_equal(x_t[:, 1], np.floor(x_t[:, 1]))


@pytest.mark.parametrize("example", list(SPECS))
def test_populate_returns_model_space_samples(tmp_path, example):
    """A whole populate of the port: samples in the model's bounds, with
    the model's fields only and its log-prior, and the auxiliary radius's
    chi(2) prior in the weights."""
    _, prop = _proposals(tmp_path, example)
    prop.populate(None, n_samples=100)
    samples = prop.samples
    assert samples.size == 100
    assert set(samples.dtype.names) >= set(prop.model.names)
    assert not set(samples.dtype.names) & (set(prop.parameters) - set(prop.model.names))
    assert prop.model.in_bounds(samples).all()
    np.testing.assert_array_equal(samples["logP"], prop.model.batch_evaluate_log_prior(samples))
    assert np.isfinite(samples["logL"]).all()
    if example == "angle":
        from scipy.stats import chi

        x = prop.x
        np.testing.assert_allclose(
            prop.log_prior(x), prop.model.batch_evaluate_log_prior(x) + chi(2).logpdf(x["theta_radial"])
        )
