"""The port's reparameterisations against the JAX package's.

Every registered name is built in both packages from the same case
(``nessai_tpu_torch.utils.testing.REPARAMETERISATION_CASES``) with a
generator of the same seed: ``update``, ``reparameterise`` (with and
without ``compute_radius``), the detected edges,
``inverse_reparameterise`` and ``log_prior`` agree to 1e-12 (float64 on
the host in both), and each device inverse (``torch_inverse`` in float32
on the CPU) agrees with the JAX ``jax_inverse`` to 1e-5. Then the spec
parser, the plugin registry, and a plugin class without a device inverse
through the populate.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nessai_tpu.reparameterisations as jax_reparams
import nessai_tpu_torch.reparameterisations as torch_reparams
from nessai_tpu.reparameterisations import utils as jax_utils
from nessai_tpu.utils import rescaling as jax_rescaling
from nessai_tpu_torch.reparameterisations import utils as torch_utils
from nessai_tpu_torch.utils import rescaling as torch_rescaling
from nessai_tpu_torch.utils.testing import REPARAMETERISATION_CASES, reparameterisation_case

NAMES = list(REPARAMETERISATION_CASES)
HOST_TOL = 1e-12
DEVICE_TOL = 1e-5


def _build(module, name, seed, n=400):
    parameters, bounds, kwargs, data = reparameterisation_case(name, n, seed)
    cls, config = module.get_reparameterisation(name)
    config.update(kwargs)
    r = cls(parameters=parameters, prior_bounds=bounds, rng=np.random.default_rng(seed + 1), **config)
    return r, data


def _x(r, data):
    """Structured x-space points: the parameters, then any auxiliary
    field (NaN until the forward pass fills it)."""
    names = list(data) + [a for a in r.auxiliary_parameters if a not in data]
    x = np.full(len(next(iter(data.values()))), np.nan, dtype=[(n, "f8") for n in names])
    for n, v in data.items():
        x[n] = v
    return x


def _forward(r, x, **kwargs):
    x_prime = np.zeros(len(x), dtype=[(p, "f8") for p in r.prime_parameters])
    return r.reparameterise(x.copy(), x_prime, np.zeros(len(x)), **kwargs)


def _inverse(r, x_like, x_prime):
    x = np.full(len(x_prime), np.nan, dtype=x_like.dtype)
    return r.inverse_reparameterise(x, x_prime.copy(), np.zeros(len(x_prime)))


def _assert_fields_close(a, b, tol):
    assert a.dtype.names == b.dtype.names
    for n in a.dtype.names:
        np.testing.assert_allclose(a[n], b[n], atol=tol, rtol=tol, equal_nan=True, err_msg=n)


def test_registries_hold_the_same_names_classes_and_arguments():
    ours, theirs = torch_reparams.default_reparameterisations, jax_reparams.default_reparameterisations
    assert list(ours) == list(theirs)
    for name, known in theirs.items():
        assert ours[name].class_fn.__name__ == known.class_fn.__name__
        assert ours[name].keyword_arguments == known.keyword_arguments
    assert set(REPARAMETERISATION_CASES) == set(theirs)


@pytest.mark.parametrize("name", NAMES, ids=str)
def test_host_operators_match_jax(name):
    ours, data = _build(torch_reparams, name, seed=3)
    theirs, _ = _build(jax_reparams, name, seed=3)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.parameters == theirs.parameters and ours.prime_parameters == theirs.prime_parameters
    assert ours.auxiliary_parameters == theirs.auxiliary_parameters
    train = _x(ours, data)
    test_data = reparameterisation_case(name, 300, 4)[3]
    x = _x(ours, test_data)
    for r in (ours, theirs):
        r.update(train)
    for compute_radius in (False, True):
        (xo, xpo, ljo), (xt, xpt, ljt) = (_forward(r, x, compute_radius=compute_radius) for r in (ours, theirs))
        _assert_fields_close(xpo, xpt, HOST_TOL)
        _assert_fields_close(xo, xt, HOST_TOL)
        np.testing.assert_allclose(ljo, ljt, atol=HOST_TOL, rtol=HOST_TOL)
        assert getattr(ours, "_edges", None) == getattr(theirs, "_edges", None)
        (bo, _, lio), (bt, _, lit) = _inverse(ours, x, xpo), _inverse(theirs, x, xpt)
        _assert_fields_close(bo, bt, HOST_TOL)
        np.testing.assert_allclose(lio, lit, atol=HOST_TOL, rtol=HOST_TOL)
        np.testing.assert_allclose(
            ours.log_prior(xo), theirs.log_prior(xt), atol=HOST_TOL, rtol=HOST_TOL
        )
    # the round trip on the host, on the data inside the live bounds:
    # x back (tiled where the inversion duplicates), the Jacobians
    # opposite
    for compute_radius in (False, True):
        _, x_prime, log_j = _forward(ours, train, compute_radius=compute_radius)
        back, _, log_j_inv = _inverse(ours, train, x_prime)
        k = len(back) // len(train)
        for p in ours.parameters:
            np.testing.assert_allclose(back[p], np.tile(train[p], k), atol=1e-8)
        np.testing.assert_allclose(log_j, -log_j_inv, atol=1e-8)
    ours.reset()
    theirs.reset()
    assert getattr(ours, "bounds", None) is None or all(
        np.array_equal(ours.bounds[p], theirs.bounds[p]) for p in ours.parameters
    )


@pytest.mark.parametrize("name", NAMES, ids=str)
def test_torch_inverse_matches_jax_inverse(name):
    """After an update (live bounds set) and a forward pass (edges
    detected), both device inverses on the same float32 columns."""
    ours, data = _build(torch_reparams, name, seed=5)
    theirs, _ = _build(jax_reparams, name, seed=5)
    x = _x(ours, data)
    ours.update(x)
    theirs.update(x)
    _, x_prime, _ = _forward(ours, x)
    _forward(theirs, x)
    assert getattr(ours, "_edges", None) == getattr(theirs, "_edges", None)
    cols = {p: x_prime[p].astype(np.float32) for p in ours.prime_parameters}
    upd_t, lj_t = ours.torch_inverse({k: torch.as_tensor(v) for k, v in cols.items()})
    fn, _ = theirs.jax_inverse()
    upd_j, lj_j = fn({k: jnp.asarray(v) for k, v in cols.items()}, theirs.jax_inverse_consts())
    assert set(upd_t) == set(upd_j)
    for p in upd_j:
        assert upd_t[p].dtype == torch.float32
        np.testing.assert_allclose(upd_t[p].numpy(), np.asarray(upd_j[p]), atol=DEVICE_TOL, rtol=DEVICE_TOL, err_msg=p)
    lj_t = lj_t.numpy() if isinstance(lj_t, torch.Tensor) else lj_t
    np.testing.assert_allclose(
        np.broadcast_to(lj_t, len(x)), np.broadcast_to(np.asarray(lj_j), len(x)), atol=DEVICE_TOL, rtol=DEVICE_TOL
    )


@pytest.mark.parametrize("name", ["logit", "log", "gaussian_cdf", "inv_gaussian_cdf"])
def test_torch_rescalings_match_the_host_functions(name):
    rng = np.random.default_rng(6)
    x = rng.uniform(0.01, 0.99, 200) if name in ("logit", "inv_gaussian_cdf", "log") else rng.normal(0, 2, 200)
    forward, inverse = torch_rescaling.get_torch_rescaling(name)
    host_forward, host_inverse = torch_rescaling.rescaling_functions[name]
    for f, h, v in ((forward, host_forward, x), (inverse, host_inverse, host_forward(x)[0])):
        out, lj = f(torch.as_tensor(v))
        ref, lj_ref = h(v)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(lj.numpy(), lj_ref, rtol=1e-10, atol=1e-10)
    assert torch_rescaling.get_torch_rescaling("unknown") is None


def test_logit_and_sigmoid_unchanged():
    """The importance sampler's maps are the JAX package's, bit for bit."""
    x = np.random.default_rng(7).uniform(-0.1, 1.1, 1000)
    for a, b in zip(torch_rescaling.logit(x), jax_rescaling.logit(x)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(torch_rescaling.sigmoid(5 * x), jax_rescaling.sigmoid(5 * x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "args",
    [
        dict(x=np.r_[np.abs(np.random.default_rng(1).normal(0, 0.1, 500)), 1.0]),
        dict(x=1 - np.abs(np.random.default_rng(2).normal(0, 0.1, 500)), allow_none=True),
        dict(x=np.random.default_rng(3).normal(0.5, 0.05, 500), allow_none=True),
        dict(x=np.random.default_rng(4).uniform(0, 1, 500), allow_both=True),
        dict(x=np.random.default_rng(5).uniform(0, 1, 500), allowed_bounds=["upper"], nbins=10),
        dict(x=np.zeros(3), test="lower"),
    ],
)
def test_detect_edge_matches_jax(args):
    assert torch_rescaling.detect_edge(**args) == jax_rescaling.detect_edge(**args)


@pytest.mark.parametrize("invert", [None, False, "upper", "lower", "both"])
@pytest.mark.parametrize("inversion", [False, True])
def test_determine_rescaled_bounds_matches_jax(invert, inversion):
    args = (-2.0, 6.0, -1.0, 4.0)
    kwargs = dict(invert=invert, inversion=inversion, offset=0.5)
    assert torch_rescaling.determine_rescaled_bounds(*args, **kwargs) == jax_rescaling.determine_rescaled_bounds(
        *args, **kwargs
    )


# ----------------------------------------------------------------------
# The spec parser
# ----------------------------------------------------------------------
MODEL_NAMES = ["x", "y", "z", "ra", "dec"]
SPECS = [
    None,
    "zscore",
    {"x": "inversion", "y": "default"},
    {"x": {"reparameterisation": "inversion", "detect_edges_kwargs": {"cutoff": 0.3}}},
    {"x": ["default", {"reparameterisation": "zscore", "parameters": "x_prime"}]},
    {"angle-pair": {"parameters": ["ra", "dec"]}},
    {"my-label": {"reparameterisation": "zscore", "parameters": ["x", "y"]}},
    {"rescaletobounds": ["x", "z"]},
    {"zscore": "y"},
    {"[xy]": "default"},
    {"default": {"parameters": ["[xz]"], "offset": True}},
    {"x": None, "y": "logit"},
]


def _spec_tuples(specs):
    return [
        (s.source_key, s.spec_index, s.reparameterisation, s.source_is_parameter, s.input_parameters, s.kwargs)
        for s in specs
    ]


@pytest.mark.parametrize("spec", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_parse_reparameterisations_matches_jax(spec):
    ours = torch_utils.parse_reparameterisations(spec, MODEL_NAMES)
    theirs = jax_utils.parse_reparameterisations(spec, MODEL_NAMES)
    assert _spec_tuples(ours) == _spec_tuples(theirs)


@pytest.mark.parametrize("spec", [1, ["x"]])
def test_parse_reparameterisations_rejects_what_jax_rejects(spec):
    for module in (torch_utils, jax_utils):
        with pytest.raises(TypeError):
            module.parse_reparameterisations(spec, MODEL_NAMES)


@pytest.mark.parametrize("patterns", [None, "x", ["x", "d.*"], ["q"], ["[xy]", "x"]])
def test_resolve_reparameterisation_parameters_matches_jax(patterns):
    available = MODEL_NAMES + ["x_prime"]
    assert torch_utils.resolve_reparameterisation_parameters(
        patterns, available
    ) == jax_utils.resolve_reparameterisation_parameters(patterns, available)


# ----------------------------------------------------------------------
# Plugins
# ----------------------------------------------------------------------
class _EntryPoint:
    def __init__(self, name, known=None, error=None):
        self.name, self._known, self._error = name, known, error

    def load(self):
        if self._error is not None:
            raise self._error
        return self._known

    def __repr__(self):
        return f"EntryPoint({self.name})"


class HostOnlyRescale(torch_reparams.Reparameterisation):
    """A plugin class with a host inverse only: x' = 2 x."""

    def reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            x_prime[pp] = 2.0 * x[p]
        return x, x_prime, log_j - len(self.parameters) * np.log(2.0)

    def inverse_reparameterise(self, x, x_prime, log_j, **kwargs):
        for p, pp in zip(self.parameters, self.prime_parameters):
            x[p] = 0.5 * x_prime[pp]
        return x, x_prime, log_j + len(self.parameters) * np.log(2.0)


def _groups(monkeypatch, groups):
    from nessai_tpu_torch.utils import entry_points

    monkeypatch.setattr(entry_points, "get_entry_points", lambda group: groups.get(group, {}))


def test_plugins_later_group_wins_and_broken_plugin_is_skipped(monkeypatch, caplog):
    known = torch_reparams.KnownReparameterisation
    first = known("host-only", torch_reparams.ScaleAndShift, {"scale": 3.0})
    second = known("host-only", HostOnlyRescale, {})
    _groups(
        monkeypatch,
        {
            "nessai.reparameterisations": {
                "a": _EntryPoint("a", first),
                "broken": _EntryPoint("broken", error=ImportError("no module")),
            },
            "nessai_tpu_torch.reparameterisations": {
                "b": _EntryPoint("b", second),
                "shapeless": _EntryPoint("shapeless", object()),
            },
        },
    )
    registry = torch_utils.ReparameterisationDict()
    registry.add_reparameterisation("default", torch_reparams.RescaleToBounds)
    with caplog.at_level(logging.WARNING):
        registry.add_external_reparameterisations("nessai.reparameterisations")
        assert registry["host-only"].class_fn is torch_reparams.ScaleAndShift
        registry.add_external_reparameterisations("nessai_tpu_torch.reparameterisations")
    assert registry["host-only"].class_fn is HostOnlyRescale
    assert registry["default"].class_fn is torch_reparams.RescaleToBounds
    assert "broken" not in registry and "shapeless" not in registry
    text = caplog.text
    assert "Could not load reparameterisation entry point EntryPoint(broken)" in text
    assert "not a KnownReparameterisation" in text
    with pytest.raises(ValueError, match="already registered"):
        registry.add_reparameterisation("default", torch_reparams.RescaleToBounds)


def test_plugin_without_torch_inverse_populates_through_the_host_inverse(tmp_path, caplog):
    """A stack member with no ``torch_inverse``: the flow inverse runs in
    the device call, the inverse reparameterisation on the host (logged
    once, by name), and the pool matches the host ``backward_pass`` of
    the same latent draws."""
    from nessai_tpu_torch.proposal import FlowProposal
    from nessai_tpu_torch.utils.testing import HalfGaussianModel

    caplog.set_level(logging.INFO)
    model = HalfGaussianModel()
    model.set_rng(np.random.default_rng(8))
    prop = FlowProposal(
        model,
        flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
        output=str(tmp_path),
        poolsize=100,
        rng=np.random.default_rng(9),
        plot=False,
        reparameterisations={"x": {"reparameterisation": HostOnlyRescale}, "y": "default"},
        device="cpu",
    )
    prop.initialise()
    assert prop._reparameterisation.torch_inverse({p: torch.zeros(2) for p in prop.prime_parameters}) is None
    assert prop._reparameterisation.no_torch_inverse == "hostonlyrescale_x"
    x = model.new_point(200)
    prop._reparameterisation.update(prop._convert_to_x(x))
    z = np.random.default_rng(10).normal(0, 0.5, (64, 2))
    x_arr, log_q, log_l, in_b = prop._fused_backward(z)
    assert log_l is None
    with torch.no_grad():
        x_prime, log_q_flow = prop.flow.flow.inverse_and_log_prob(torch.as_tensor(z, dtype=torch.float32))
    x_prime = x_prime.double().numpy()
    np.testing.assert_allclose(x_arr[:, 0], 0.5 * x_prime[:, 0], atol=1e-12)
    rtb = prop._reparameterisation["rescaletobounds_y"]
    lo, hi = rtb.bounds["y"]
    np.testing.assert_allclose(x_arr[:, 1], (hi - lo) * (x_prime[:, 1] + 1) / 2 + lo, atol=1e-12)
    np.testing.assert_array_equal(in_b, model.in_bounds(prop.inverse_rescale(_prime(prop, x_prime))[0]))
    prop.populate(None, n_samples=50)
    prop.populate(None, n_samples=50)
    assert caplog.text.count("hostonlyrescale_x has no device inverse") == 1
    assert prop.samples.size == 50
    np.testing.assert_array_equal(prop.samples["logL"], model.log_likelihood(prop.samples))
    assert model.in_bounds(prop.samples).all()


def _prime(prop, x_prime):
    out = np.zeros(len(x_prime), dtype=prop.x_prime_dtype)
    for i, p in enumerate(prop.prime_parameters):
        out[p] = x_prime[:, i]
    return out
