"""The port's truncation-scheme layer against the JAX package's: every
rule and mode on the same latent draws, log q and likelihoods (radii,
fuzz factors and kept masks exactly, the radii to 1e-12), the scheme
built from list, dict and deprecated-keyword configs, the helpers that
normalise the proposal's truncation keywords, the proposal's
``configure_truncation``, and whole populates with the rules through
converted weights against the JAX package's ``rounds`` populate."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.proposal.flowproposal import FlowProposal as JaxFlowProposal
from nessai_tpu.proposal.flowproposal import truncation as jax_truncation
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.flows import params_from_jax
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.proposal.flowproposal import FlowProposal
from nessai_tpu_torch.proposal.flowproposal import truncation
from nessai_tpu_torch.utils.testing import IntegrationTestModel

#: radii and log q cuts: both packages compute them in float64 numpy
RADIUS_RTOL = 1e-12
#: pools through converted float32 flows: the JAX package's populate
#: tests hold them to this
POOL_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


class _Stub:
    """What a rule reads of its proposal."""

    def __init__(self, dims, seed, z_train=None, log_q=None):
        self.prime_dims = dims
        self.rng = np.random.default_rng(seed)
        self.training_latent = z_train
        self.training_log_q = log_q
        self.r = None


def _assert_same(u, v):
    """Equal arrays; structured ones (with their NaN fields) byte for
    byte."""
    if u.dtype.names:
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    else:
        np.testing.assert_array_equal(u, v)


def _rule_pair(name, kwargs):
    return truncation.get_truncation_rule(name)(**kwargs), jax_truncation.get_truncation_rule(name)(**kwargs)


@pytest.mark.parametrize("dims", [1, 2, 5])
@pytest.mark.parametrize(
    "kwargs, radius",
    [
        (dict(mode="constant_volume", q=0.9), None),
        (dict(mode="constant_volume", volume_fraction=0.99, fuzz=1.3), None),
        (dict(mode="fixed", radius=1.7), None),
        (dict(fixed_radius=2.5, max_radius=2.0), None),
        (dict(mode="adaptive"), None),
        (dict(mode="adaptive", expansion_fraction=0.0, min_radius=4.0), None),
        (dict(mode="adaptive", expansion_fraction=1.5, max_radius=1.0), None),
        (dict(radius_mode="adaptive", fuzz=2.0, expansion_fraction=0), None),
        (dict(mode="constant_volume"), 1.25),
    ],
    ids=lambda v: str(v),
)
def test_latent_radius_matches_jax(dims, kwargs, radius):
    """Every mode: the radius, the fuzz, the truncated draws and the cut
    of given points."""
    rng = np.random.default_rng(dims)
    z_train = rng.normal(size=(300, dims))
    ours, theirs = _rule_pair("latent_radius", dict(kwargs))
    a, b = _Stub(dims, 7, z_train), _Stub(dims, 7, z_train)
    ours.prepare(a, None, radius=radius)
    theirs.prepare(b, None, radius=radius)
    np.testing.assert_allclose(ours.r, theirs.r, rtol=RADIUS_RTOL, atol=0)
    assert a.r == ours.r and ours.fuzz == theirs.fuzz and ours.mode == theirs.mode
    np.testing.assert_allclose(ours.threshold, theirs.threshold, rtol=RADIUS_RTOL, atol=0)
    np.testing.assert_array_equal(ours.sample_latent(a, 200), theirs.sample_latent(b, 200))
    z = 1.5 * rng.normal(size=(500, dims))
    np.testing.assert_array_equal(ours.apply_latent(a, z), theirs.apply_latent(b, z))
    assert ours.to_kwargs() == theirs.to_kwargs()
    for attr in ("radius_mode", "constant_volume_mode", "volume_fraction", "fixed_radius"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    ours.configure(a)
    theirs.configure(b)
    assert ours.fuzz == theirs.fuzz
    ours.reset()
    theirs.reset()
    assert (ours.r, ours._dist) == (theirs.r, theirs._dist)


def test_latent_radius_errors_match_jax():
    for package in (truncation, jax_truncation):
        with pytest.raises(ValueError, match="Unknown latent_radius mode"):
            package.LatentRadiusTruncation(mode="no")
        with pytest.raises(RuntimeError, match="requires trained proposal"):
            package.LatentRadiusTruncation(mode="adaptive").prepare(_Stub(2, 0), None)
        with pytest.raises(RuntimeError, match="fixed mode requires a radius"):
            package.LatentRadiusTruncation(mode="fixed").prepare(_Stub(2, 0), None)


def test_latent_radius_leaves_other_bases_to_the_proposal():
    """For a base other than the unit Gaussian the rule draws nothing (the
    proposal draws from the base) and only cuts at the radius."""
    rule = truncation.LatentRadiusTruncation(mode="fixed", radius=1.0)
    stub = _Stub(2, 0)
    rule.prepare(stub, None)
    stub.latent_is_unit_gaussian = False
    assert rule.sample_latent(stub, 10) is None


@pytest.mark.parametrize("threshold", [None, -2.5])
def test_min_log_q_matches_jax(threshold):
    rng = np.random.default_rng(1)
    log_q_train = rng.normal(-3.0, 1.0, 400)
    ours, theirs = _rule_pair("min_log_q", dict(threshold=threshold))
    a, b = _Stub(2, 0, log_q=log_q_train), _Stub(2, 0, log_q=log_q_train)
    ours.prepare(a, None)
    theirs.prepare(b, None)
    assert ours.min_log_q == theirs.min_log_q
    x = numpy_array_to_live_points(rng.normal(size=(1000, 2)), ["a", "b"])
    log_q, z = rng.normal(-3.0, 2.0, 1000), rng.normal(size=(1000, 2))
    for u, v in zip(ours.apply_after_backward(a, x, log_q, z), theirs.apply_after_backward(b, x, log_q, z)):
        _assert_same(u, v)
    ours.reset()
    theirs.reset()
    assert ours.min_log_q is theirs.min_log_q is None


@pytest.mark.parametrize("worst", [None, -1.5])
def test_likelihood_threshold_matches_jax(worst):
    rng = np.random.default_rng(2)
    ours, theirs = _rule_pair("likelihood_threshold", {})
    assert ours.requires_log_likelihood and theirs.requires_log_likelihood
    worst_point = None if worst is None else numpy_array_to_live_points(np.zeros((1, 2)), ["a", "b"])[0]
    if worst_point is not None:
        worst_point["logL"] = worst
    ours.prepare(None, worst_point)
    theirs.prepare(None, worst_point)
    assert ours.threshold == theirs.threshold
    x = numpy_array_to_live_points(rng.normal(size=(800, 2)), ["a", "b"])
    x["logL"] = rng.normal(-1.5, 1.0, 800)
    log_q, z = rng.normal(size=800), rng.normal(size=(800, 2))
    for u, v in zip(ours.apply_after_likelihood(None, x, log_q, z), theirs.apply_after_likelihood(None, x, log_q, z)):
        _assert_same(u, v)


@pytest.mark.parametrize(
    "config",
    [
        None,
        "latent_radius",
        ["latent_radius", "min_log_q"],
        ("min_log_q", "likelihood_threshold"),
        {"latent_radius": {"mode": "fixed", "radius": 2.0}, "min_log_q": {"threshold": -4.0}},
        {"latent_radius": dict(constant_volume_mode=True, volume_fraction=0.8)},
        {"latent_radius": dict(fixed_radius=3.0, compute_radius_with_all=True)},
        {"likelihood_threshold": None, "latent_radius": {"radius_mode": "adaptive", "fuzz": 1.2}},
    ],
    ids=str,
)
def test_scheme_from_config_matches_jax(config):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = truncation.TruncationScheme.from_config(config, rng=np.random.default_rng(0))
        theirs = jax_truncation.TruncationScheme.from_config(config, rng=np.random.default_rng(0))
    assert ours.rule_names == theirs.rule_names
    assert ours.requires_log_likelihood == theirs.requires_log_likelihood
    for name in ours.rule_names:
        assert ours.has_rule(name) and theirs.has_rule(name)
        a, b = ours.get_rule(name), theirs.get_rule(name)
        if hasattr(b, "to_kwargs"):
            assert a.to_kwargs() == b.to_kwargs()
    assert ours.get_rule("nope") is theirs.get_rule("nope") is None


def test_scheme_add_rule_and_registry_match_jax():
    for package in (truncation, jax_truncation):
        scheme = package.TruncationScheme.from_config(["min_log_q"])
        scheme.add_rule(package.LatentRadiusTruncation(mode="fixed", radius=1.0), index=0)
        assert scheme.rule_names == ["latent_radius", "min_log_q"]
        with pytest.raises(ValueError, match="Duplicate truncation rule"):
            scheme.add_rule(package.MinLogQTruncation())
        with pytest.raises(ValueError, match="Unknown truncation rule"):
            package.get_truncation_rule("nope")
        assert package.get_truncation_rule_class("min_log_q") is package.MinLogQTruncation
    assert sorted(truncation.TRUNCATION_REGISTRY) == sorted(jax_truncation.TRUNCATION_REGISTRY)
    assert truncation.BaseTruncationRule is truncation.TruncationRule


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(truncation_method="min_log_q"),
        dict(truncation_methods=["likelihood_threshold", "min_log_q", "min_log_q"]),
        dict(truncation_methods="latent_radius", truncate_log_q=True, enforce_likelihood_threshold=True),
        dict(latent_radius_kwargs={"mode": "fixed", "radius": 2.0}),
        dict(default_latent_radius=True, truncation_method="min_log_q"),
        dict(default_latent_radius=True),
    ],
    ids=str,
)
def test_method_helpers_match_jax(kwargs):
    for name in ("build_truncation_methods",):
        assert getattr(truncation, name)(**kwargs) == getattr(jax_truncation, name)(**kwargs)
    methods = truncation.build_truncation_methods(**kwargs)
    for default in (False, True):
        ours = truncation.apply_default_truncation_config(methods, {"min_log_q": {"threshold": 1.0}},
                                                          default_latent_radius=default)
        theirs = jax_truncation.apply_default_truncation_config(methods, {"min_log_q": {"threshold": 1.0}},
                                                                default_latent_radius=default)
        assert ours == theirs


@pytest.mark.parametrize(
    "args",
    [
        dict(truncation_method="min_log_q", truncation_kwargs={"threshold": 2.0}),
        dict(truncation_method="min_log_q", truncation_kwargs={"min_log_q": {"threshold": 2.0}}),
        dict(truncation_methods=["min_log_q"], truncation_kwargs={"threshold": 2.0}),
        dict(truncation_kwargs=None),
        dict(truncation_method="latent_radius", truncation_kwargs={"latent_radius": {"q": 0.5}, "x": 1}),
    ],
    ids=str,
)
def test_kwargs_helpers_match_jax(args):
    assert truncation.normalise_truncation_kwargs(**args) == jax_truncation.normalise_truncation_kwargs(**args)
    methods = dict(truncation_method=args.get("truncation_method"),
                   truncation_methods=args.get("truncation_methods"))
    assert truncation.normalise_truncation_methods(**methods) == jax_truncation.normalise_truncation_methods(
        **methods)


def test_deprecated_latent_radius_keywords_match_jax():
    kwargs = dict(fuzz=1.2, fixed_radius=None, radius_mode="fixed", volume_fraction=0.9, other=3)
    assert truncation.get_deprecated_latent_radius_kwargs(**kwargs) == (
        jax_truncation.get_deprecated_latent_radius_kwargs(**kwargs))
    assert truncation.get_deprecated_latent_radius_arguments(**kwargs) == (
        jax_truncation.get_deprecated_latent_radius_arguments(**kwargs))
    assert truncation.LEGACY_LATENT_RADIUS_ARGUMENTS == jax_truncation.LEGACY_LATENT_RADIUS_ARGUMENTS
    assert truncation.should_enable_latent_radius({"q": 1}) and not truncation.should_enable_latent_radius(None)


#: the flow proposal's truncation keywords, as users set them
CONFIGURE_CASES = [
    dict(),
    dict(constant_volume_mode=False),
    dict(constant_volume_mode=False, expansion_fraction=1.0, fuzz=1.1),
    dict(volume_fraction=0.9, fuzz=1.2),
    dict(fixed_radius=2.0),
    dict(radius_mode="adaptive", min_radius=0.5, max_radius=4.0),
    dict(truncation="min_log_q"),
    dict(truncation=["latent_radius", "min_log_q", "likelihood_threshold"]),
    dict(truncation={"latent_radius": {"mode": "fixed", "radius": 3.0}}, truncate_log_q=True),
    dict(truncation_method="min_log_q", truncation_kwargs={"threshold": -3.0}),
    dict(truncation_methods=["likelihood_threshold"], enforce_likelihood_threshold=True),
    dict(latent_radius_kwargs={"mode": "fixed", "radius": 1.5}),
    dict(latent_radius_kwargs={"q": 0.5}, default_latent_radius=True),
    dict(compute_radius_with_all=True),
    dict(enforce_likelihood_threshold=True, truncate_log_q=True),
]


@pytest.mark.parametrize("kwargs", CONFIGURE_CASES, ids=str)
def test_configure_truncation_matches_jax(tmp_path, kwargs):
    """The proposal's keywords give the JAX package's truncation config,
    and the scheme built from it the same rules."""
    common = dict(output=str(tmp_path), rng=np.random.default_rng(0), poolsize=100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = FlowProposal(IntegrationTestModel(2), plot=False, device="cpu", **common, **kwargs)
        theirs = JaxFlowProposal(JaxModel(2), **common, **kwargs)
    assert ours._truncation_config == theirs._truncation_config
    assert ours.truncation_methods == theirs.truncation_methods
    assert ours.truncate_log_q == theirs.truncate_log_q
    assert ours.enforce_likelihood_threshold == theirs.enforce_likelihood_threshold


def test_configure_truncation_errors_match_jax(tmp_path):
    for cls, model in ((FlowProposal, IntegrationTestModel), (JaxFlowProposal, JaxModel)):
        extra = dict(device="cpu") if cls is FlowProposal else {}
        with pytest.raises(ValueError, match="Specify only one"):
            cls(model(2), output=str(tmp_path), truncation_method="a", truncation_methods=["b"], **extra)
        with pytest.raises(TypeError, match="must be a dictionary"):
            cls(model(2), output=str(tmp_path), truncation_methods=["min_log_q"],
                truncation_kwargs={"min_log_q": 3}, **extra)
        with pytest.raises(TypeError, match="latent_temperature must be a float"):
            cls(model(2), output=str(tmp_path), latent_temperature=True, **extra)
        with pytest.raises(ValueError, match="latent_temperature must be positive"):
            cls(model(2), output=str(tmp_path), latent_temperature=-1.0, **extra)
        with pytest.warns(DeprecationWarning, match="latent_prior is deprecated"):
            cls(model(2), output=str(tmp_path), latent_prior="truncated_gaussian", **extra)


def test_device_loop_names_its_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 7"):
        FlowProposal(IntegrationTestModel(2), output=str(tmp_path), populate_mode="device_loop", device="cpu")
    with pytest.raises(ValueError, match="Unknown populate_mode"):
        FlowProposal(IntegrationTestModel(2), output=str(tmp_path), populate_mode="other", device="cpu")


def _proposals(tmp_path, seed=17, **kwargs):
    """The same flow (converted weights) and host generators in both
    packages, the JAX package on its rounds populate."""
    flow_config = dict(n_blocks=2, n_neurons=8, n_layers=1)
    jmodel, tmodel = JaxModel(2), IntegrationTestModel(2)
    jmodel.set_rng(np.random.default_rng(seed))
    tmodel.set_rng(np.random.default_rng(seed))
    common = dict(flow_config=flow_config, poolsize=300, **kwargs)
    jprop = JaxFlowProposal(jmodel, output=str(tmp_path / "jax"), rng=np.random.default_rng(seed + 1),
                            populate_mode="rounds", fuse_likelihood=True, **common)
    tprop = FlowProposal(tmodel, output=str(tmp_path / "torch"), rng=np.random.default_rng(seed + 1), plot=False,
                         device="cpu", **common)
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
    for i, name in enumerate(jmodel.names):
        train[name] = 0.1 * train[name] + 0.3 * i
    jprop._reparameterisation.update(train)
    tprop._reparameterisation.update(train)
    # the training data's images, as a training leaves them
    x_prime, _ = tprop.rescale(train)
    x_prime = np.stack([x_prime[p] for p in tprop.prime_parameters], axis=1)
    z, log_q = tprop.flow.forward_and_log_prob(x_prime)
    for prop in (jprop, tprop):
        prop.training_latent, prop.training_log_q = z, log_q
    return jprop, tprop, train


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(constant_volume_mode=False),
        dict(fixed_radius=1.8, drawsize=700),
        dict(truncation=["latent_radius", "min_log_q", "likelihood_threshold"]),
        dict(truncation={"latent_radius": {"mode": "fixed", "radius": 2.0}, "min_log_q": {}}, latent_temperature=1.5),
        dict(accumulate_weights=True, max_samples=50_000),
        dict(truncation={"latent_radius": {"mode": "fixed", "radius": 3.0}}, check_acceptance=True),
    ],
    ids=str,
)
def test_populate_with_rules_matches_jax_rounds(tmp_path, kwargs):
    """A populate with the rules from the same weights and generators:
    the same acceptance, pop order, likelihood count and, to float32
    rounding, the same pool."""
    jprop, tprop, train = _proposals(tmp_path, **kwargs)
    worst = train[np.argsort(jprop.model.log_likelihood(train))[30]].copy()
    worst["logL"] = jprop.model.log_likelihood(worst[None])[0]
    jprop.populate(worst, n_samples=300)
    tprop.populate(worst, n_samples=300)
    assert tprop.samples.size == jprop.samples.size > 0
    assert tprop.population_acceptance == jprop.population_acceptance
    assert tprop.indices == jprop.indices
    assert tprop.model.likelihood_evaluations == jprop.model.likelihood_evaluations
    np.testing.assert_allclose(getattr(tprop, "r", None) or 0.0, getattr(jprop, "r", None) or 0.0,
                               rtol=RADIUS_RTOL)
    for name in ("x_0", "x_1", "logL", "logP"):
        np.testing.assert_allclose(tprop.samples[name], jprop.samples[name], atol=POOL_ATOL, rtol=0)
    np.testing.assert_allclose(tprop.acceptance, jprop.acceptance, atol=0, rtol=0)
