"""The rest of the flows layer against the JAX package's: ``LULinear``,
``SVDLinear``, ``Logit``, ``MaskedAffineAutoregressive``, the base
distributions (``MultivariateNormal``, ``MultivariateUniform``,
``ResampledGaussian``/LARS), conditioner dropout and ``configure_model``
over every flow type, linear transform, pre-transform and base.

The same numpy-seeded inputs and weights go through both packages (the
port's weights converted by ``flows/convert.py``). Tolerances: outputs
and log-determinants of one bijector atol 1e-5 + rtol 1e-5 (float32 on
both sides; the triangular solves and the MADE inverse's loop round
differently from XLA's); a whole flow's log-density atol 1e-4 + rtol
1e-5 (a chain of up to 14 bijectors in float32); LARS arithmetic on given
draws 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nessai_tpu.flows.distributions as jax_distributions
from nessai_tpu.flows import bijectors as jbij
from nessai_tpu.flows.base import Flow as JaxFlow
from nessai_tpu.flows.distributions import StandardNormal as JaxStandardNormal
from nessai_tpu.flows.utils import configure_model as jax_configure_model
from nessai_tpu.flows.utils import reset_weights as jax_reset_weights
from nessai_tpu_torch.flows import bijectors as tbij
from nessai_tpu_torch.flows import configure_model, distributions, params_from_jax, params_to_jax
from nessai_tpu_torch.flows.base import Flow
from nessai_tpu_torch.flows.utils import get_base_distribution, reset_weights

ATOL = RTOL = 1e-5
FLOW_ATOL, FLOW_RTOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def highest_precision():
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(previous)


def _perturb(params, seed, scale=0.1):
    """The JAX pytree as numpy, every float leaf moved by scale N(0, 1)."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(move, params)


def _single(jax_bijector, torch_bijector, dim, seed):
    """The same bijector in both packages, each as a one-element chain
    on a unit Gaussian, with perturbed JAX weights loaded into the port."""
    jflow = JaxFlow(jbij.Chain([jax_bijector]), JaxStandardNormal(dim), dim)
    params = _perturb(jflow.init(jax.random.PRNGKey(seed)), seed)
    tflow = Flow(tbij.Chain([torch_bijector]), distributions.StandardNormal(dim), dim)
    params_from_jax(tflow, params)
    return jflow, params, tflow


BIJECTORS = {
    "lu": (lambda d: jbij.LULinear(d), lambda d: tbij.LULinear(d)),
    "lu_random_init": (lambda d: jbij.LULinear(d, identity_init=False), lambda d: tbij.LULinear(d, identity_init=False)),
    "svd": (lambda d: jbij.SVDLinear(d), lambda d: tbij.SVDLinear(d)),
    "svd_three_reflections": (lambda d: jbij.SVDLinear(d, num_householder=3),
                              lambda d: tbij.SVDLinear(d, num_householder=3)),
    "logit": (lambda d: jbij.Logit(), lambda d: tbij.Logit()),
    "maf": (lambda d: jbij.MaskedAffineAutoregressive(d, n_neurons=8),
            lambda d: tbij.MaskedAffineAutoregressive(d, n_neurons=8)),
    "maf_one_layer_tanh": (lambda d: jbij.MaskedAffineAutoregressive(d, n_neurons=5, n_layers=1, activation="tanh"),
                           lambda d: tbij.MaskedAffineAutoregressive(d, n_neurons=5, n_layers=1, activation="tanh")),
}


@pytest.mark.parametrize("dim", [2, 5])
@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_matches_jax(name, dim):
    """Forward, inverse and both log-determinants on converted weights."""
    make_jax, make_torch = BIJECTORS[name]
    jflow, params, tflow = _single(make_jax(dim), make_torch(dim), dim, seed=dim)
    rng = np.random.default_rng(dim + 1)
    x = rng.uniform(0.02, 0.98, (64, dim)) if name == "logit" else rng.normal(size=(64, dim))
    x = x.astype(np.float32)
    for method in ("forward", "inverse"):
        ours = getattr(tflow, method)(torch.as_tensor(x))
        theirs = getattr(jflow, method)(params, jnp.asarray(x))
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    z, ld = tflow(torch.as_tensor(x))
    back, ld_inv = tflow.inverse(z)
    np.testing.assert_allclose(back.detach().numpy(), x, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose((ld + ld_inv).detach().numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("dim,n_neurons,n_layers", [(2, 8, 2), (4, 5, 1), (6, 16, 3)])
def test_made_masks_are_the_jax_packages(dim, n_neurons, n_layers):
    """The masks of the MADE conditioner and its autoregressive structure:
    output i (scale and shift) depends on inputs before i alone."""
    ours = tbij.made_masks(dim, n_neurons, n_layers)
    theirs = jbij.MaskedAffineAutoregressive(dim, n_neurons, n_layers).masks
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    maf = tbij.MaskedAffineAutoregressive(dim, n_neurons, n_layers, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in maf.layers:
            layer.weight.normal_()
    x = torch.randn(1, dim, requires_grad=True)
    s, t = maf._net(x)
    for i in range(dim):
        grad = torch.autograd.grad(s[0, i] + t[0, i], x, retain_graph=True)[0][0]
        assert torch.count_nonzero(grad[i:]) == 0


def test_lu_starts_at_the_identity_and_svd_at_a_rotation():
    """With the identity initialisation an LU layer is the identity and
    an SVD layer an orthogonal map (random reflections, unit singular
    values): both keep the volume."""
    x = torch.randn(10, 3)
    z, ld = tbij.LULinear(3)(x)
    torch.testing.assert_close(z, x, atol=1e-6, rtol=1e-6)
    assert torch.count_nonzero(ld) == 0
    z, ld = tbij.SVDLinear(3, generator=torch.Generator().manual_seed(1))(x)
    torch.testing.assert_close(z.norm(dim=1), x.norm(dim=1), atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(ld) == 0


def test_logit_clips_and_inverts():
    b = tbij.Logit()
    x = torch.tensor([[0.0, 0.5], [1.0, 0.25]])
    z, ld = b(x)
    assert torch.isfinite(z).all() and torch.isfinite(ld).all()
    back, _ = b.inverse(z)
    torch.testing.assert_close(back[:, 1], x[:, 1])


def test_base_distributions_match_jax():
    """log_prob of every base distribution on the same points (LARS on
    converted, perturbed weights), -inf outside the uniform box."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(200, 3)).astype(np.float32)
    pairs = [
        (jax_distributions.MultivariateNormal(3, var=2.5), distributions.MultivariateNormal(3, var=2.5)),
        (jax_distributions.MultivariateNormal(shape=(3,), var=0.5), distributions.MultivariateNormal(shape=(3,), var=0.5)),
        (jax_distributions.MultivariateUniform(3), distributions.MultivariateUniform(3)),
        (jax_distributions.MultivariateUniform(3, -2.0, 0.5), distributions.MultivariateUniform(3, -2.0, 0.5)),
        (jax_distributions.StandardNormal(3), distributions.StandardNormal(3)),
    ]
    for jd, td in pairs:
        theirs = np.asarray(jd.log_prob({}, jnp.asarray(z)))
        ours = td.log_prob(torch.as_tensor(z)).numpy()
        np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(theirs))
        fin = np.isfinite(theirs)
        np.testing.assert_allclose(ours[fin], theirs[fin], atol=ATOL, rtol=RTOL)
    assert np.isfinite(theirs).any()
    jd = jax_distributions.ResampledGaussian(3, n_neurons=16)
    params = _perturb(jd.init(jax.random.PRNGKey(1)), 2, scale=0.5)
    td = distributions.ResampledGaussian(3, n_neurons=16)
    flow = Flow(tbij.Chain([]), td, 3)
    params_from_jax(flow, {"bijector": [], "base": params})
    np.testing.assert_allclose(
        td.log_prob(torch.as_tensor(z)).detach().numpy(), np.asarray(jd.log_prob(params, jnp.asarray(z))),
        atol=ATOL, rtol=RTOL,
    )
    with pytest.raises(ValueError, match="either dim or shape"):
        distributions.MultivariateNormal(3, shape=(3,))


@pytest.mark.parametrize("decay,n", [(0.99, 500), (0.5, 1000), (0.0, 2000)])
def test_lars_update_log_z_matches_jax_on_given_draws(monkeypatch, decay, n):
    """The LARS normalisation's Monte Carlo estimate and its moving
    average, on the same standard-normal draws in both packages (the
    JAX package's draws replaced by them), to 1e-6."""
    rng = np.random.default_rng(n)
    z = rng.standard_normal((n, 2)).astype(np.float32)
    jd = jax_distributions.ResampledGaussian(2, n_neurons=8)
    params = _perturb(jd.init(jax.random.PRNGKey(0)), 3, scale=1.0)
    params["log_Z"] = np.float32(-0.4)
    monkeypatch.setattr(jax_distributions.jax.random, "normal", lambda key, shape: jnp.asarray(z))
    theirs = jd.update_log_z(params, jax.random.PRNGKey(0), n=n, decay=decay)
    td = distributions.ResampledGaussian(2, n_neurons=8)
    params_from_jax(Flow(tbij.Chain([]), td, 2), {"bijector": [], "base": params})
    estimate = td.estimate_log_z(z=torch.as_tensor(z))
    np.testing.assert_allclose(float(estimate), float(jd.estimate_log_z(params, jax.random.PRNGKey(0), n)), atol=1e-6)
    td.update_log_z(decay=decay, z=torch.as_tensor(z))
    np.testing.assert_allclose(float(td.log_Z.detach()), float(theirs["log_Z"]), atol=1e-6)


def test_lars_finalise_and_sampling():
    """``finalise`` replaces log_Z by a fresh estimate over n_samples x
    n_batches draws; ``sample`` accepts each proposal with probability
    a(z) and takes the last of T proposals where none was accepted."""
    td = distributions.ResampledGaussian(2, n_neurons=8, n_layers=1, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    td.finalise(n_samples=1000, n_batches=2, generator=gen)
    # a zero last layer: a = 1/2 everywhere, so log Z = log 1/2
    assert math.isclose(float(td.log_Z.detach()), math.log(0.5), abs_tol=1e-6)
    with torch.no_grad():
        # a(z) = sigmoid(20 tanh(5 z_0)): z_0 > 0 is accepted, z_0 < 0
        # rarely (a share of about 0.96 of the draws has z_0 > 0)
        td.net.out.weight.zero_()
        td.net.layers[0].weight.zero_()
        td.net.layers[0].weight[0, 0] = 5.0
        td.net.out.weight[0, 0] = 20.0
    x = td.sample(4000, torch.Generator().manual_seed(2))
    assert x.shape == (4000, 2) and torch.isfinite(x).all()
    assert float((x[:, 0] > 0).float().mean()) > 0.9
    one_round = distributions.ResampledGaussian(2, n_neurons=8, T=1)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    torch.testing.assert_close(one_round.sample(50, g1), torch.randn(50, 2, generator=g2))


def test_base_samples():
    """Unit Gaussian draws are one ``torch.randn`` on the generator (the
    INS pins rest on it); the other bases' draws follow their laws."""
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert torch.equal(distributions.StandardNormal(3).sample(100, g1), torch.randn(100, 3, generator=g2))
    x = distributions.MultivariateNormal(2, var=4.0).sample(20000, torch.Generator().manual_seed(1))
    assert abs(float(x.std()) - 2.0) < 0.05
    u = distributions.MultivariateUniform(2, -1.0, 3.0).sample(5000, torch.Generator().manual_seed(2))
    assert float(u.min()) >= -1.0 and float(u.max()) <= 3.0 and abs(float(u.mean()) - 1.0) < 0.1
    flow = configure_model(dict(n_inputs=2, ftype="nsf", tails=None, distribution="uniform", linear_transform=None,
                                n_neurons=4))
    x, log_p = flow.sample_and_log_prob(300, torch.Generator().manual_seed(3))
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    torch.testing.assert_close(log_p, flow.log_prob(x), atol=1e-4, rtol=1e-4)


FTYPES = ["realnvp", "nsf", "maf"]
LINEAR = ["permutation", "lu", "svd", None]
PRE = [None, "logit"]
BASES = {
    "normal": dict(distribution="normal"),
    "mvn": dict(distribution="mvn", distribution_kwargs=dict(var=2.0)),
    "uniform": dict(distribution="uniform", tails=None),
    "lars": dict(distribution="lars", distribution_kwargs=dict(n_neurons=16)),
}


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("pre_transform", PRE)
@pytest.mark.parametrize("linear_transform", LINEAR)
@pytest.mark.parametrize("ftype", FTYPES)
def test_configure_model_matches_jax(ftype, linear_transform, pre_transform, base):
    """Every combination the JAX package accepts: the same chain and base,
    and the same log-density (finite at the same points) on converted,
    perturbed weights; the port's flow inverts its forward."""
    cfg = dict(n_inputs=3, n_blocks=2, n_neurons=8, ftype=ftype, linear_transform=linear_transform,
               pre_transform=pre_transform, **BASES[base])
    jflow, params, _ = jax_configure_model(cfg)
    params = _perturb(params, seed=len(str(cfg)))
    tflow = configure_model(cfg)
    assert [type(b).__name__ for b in tflow.bijector.bijectors] == [
        type(b).__name__ for b in jflow.bijector.bijectors
    ]
    assert type(tflow.base).__name__ == type(jflow.base).__name__
    params_from_jax(tflow, params)
    rng = np.random.default_rng(1)
    unit = pre_transform == "logit" or base == "uniform"
    x = (rng.uniform(0.02, 0.98, (64, 3)) if unit else rng.normal(size=(64, 3))).astype(np.float32)
    theirs = np.asarray(jflow.log_prob(params, jnp.asarray(x)))
    with torch.no_grad():
        ours = tflow.log_prob(torch.as_tensor(x)).numpy()
        z, ld = tflow(torch.as_tensor(x))
        back, _ = tflow.inverse(z)
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(theirs))
    fin = np.isfinite(theirs)
    np.testing.assert_allclose(ours[fin], theirs[fin], atol=FLOW_ATOL, rtol=FLOW_RTOL)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("ftype", FTYPES)
def test_dropout_only_in_training_mode(ftype):
    """Conditioner dropout: a built flow is in evaluation mode, where it is
    the JAX package's flow without a dropout key; in training mode the
    log-density changes from call to call."""
    cfg = dict(n_inputs=3, n_blocks=2, n_neurons=16, ftype=ftype, dropout_probability=0.3,
               net="mlp" if ftype == "nsf" else "resnet")
    jflow, params, _ = jax_configure_model(cfg)
    params = _perturb(params, seed=9)
    tflow = configure_model(cfg)
    params_from_jax(tflow, params)
    assert not tflow.training
    x = np.random.default_rng(2).normal(size=(32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = tflow.log_prob(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(ours, np.asarray(jflow.log_prob(params, jnp.asarray(x))), atol=FLOW_ATOL,
                                   rtol=FLOW_RTOL)
        tflow.train()
        first, second = (tflow.log_prob(torch.as_tensor(x)).numpy() for _ in range(2))
    assert not np.allclose(first, ours) and not np.allclose(first, second)
    no_dropout = configure_model(dict(cfg, dropout_probability=0.0))
    assert not any(isinstance(m, torch.nn.Dropout) for m in no_dropout.modules())


def test_flow_model_trains_with_dropout_in_training_mode_only(tmp_path):
    """The optimiser steps see the flow in training mode; validation and
    everything after training see it in evaluation mode."""
    from nessai_tpu_torch.flowmodel import FlowModel

    fm = FlowModel(dict(n_inputs=2, n_blocks=2, n_neurons=8, dropout_probability=0.2),
                   dict(max_epochs=3, patience=5), output=str(tmp_path), rng=np.random.default_rng(0), device="cpu")
    fm.initialise()
    modes = []
    step, loss = fm._train_step, fm._loss
    fm._train_step = lambda x, w=None: (modes.append(("step", fm.flow.training)), step(x, w))[1]
    fm._loss = lambda x, w=None: (modes.append(("loss", fm.flow.training)), loss(x, w))[1]
    fm.train(np.random.default_rng(1).normal(size=(200, 2)), save=False)
    assert ("step", True) in modes and ("loss", False) in modes
    # the loss inside a step is taken in training mode, the validation's not
    assert all(training for kind, training in modes if kind == "step")
    assert not fm.flow.training


@pytest.mark.parametrize("ftype,extra", [("maf", {}), ("realnvp", dict(linear_transform="lu")),
                                         ("nsf", dict(linear_transform="svd", distribution="lars"))])
def test_reset_weights_covers_every_module(ftype, extra):
    """Fresh weights for the linear layers, the MADE nets and a LARS
    base, as a new flow from the config starts; the permutations keep
    their order."""
    cfg = dict(n_inputs=3, n_blocks=3, n_neurons=8, ftype=ftype, **extra)
    flow = configure_model(dict(cfg, seed=1))
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(1.0)
    perms = [b.perm.clone() for b in flow.bijector.bijectors if isinstance(b, tbij.Permutation)]
    gen = torch.Generator().manual_seed(5)
    reset_weights(flow, cfg, gen)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(5)))
    fresh = configure_model(dict(cfg, seed=seed))
    for (k, a), (_, b) in zip(flow.state_dict().items(), fresh.state_dict().items()):
        if not k.endswith("perm") and not k.endswith("inv"):
            assert torch.equal(a, b), k
    assert all(torch.equal(a, b.perm) for a, b in zip(
        perms, [b for b in flow.bijector.bijectors if isinstance(b, tbij.Permutation)]))
    # the JAX package resets the same parameters: all but the permutations
    jflow, params, _ = jax_configure_model(cfg)
    new = jax_reset_weights(jflow, params, jax.random.PRNGKey(3))
    assert set(new) == {"bijector", "base"}


@pytest.mark.parametrize("ftype,extra", [
    ("maf", {}), ("realnvp", dict(linear_transform="lu", pre_transform="logit")),
    ("nsf", dict(linear_transform="svd", distribution="lars", tails=None)),
])
def test_converter_round_trip_is_exact(ftype, extra):
    cfg = dict(n_inputs=3, n_blocks=2, n_neurons=8, ftype=ftype, **extra)
    jflow, params, _ = jax_configure_model(cfg)
    params = _perturb(params, seed=4)
    tflow = configure_model(cfg)
    params_from_jax(tflow, params)
    back = params_to_jax(tflow)
    leaves, theirs = jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, params))
    assert len(leaves) == len(theirs)
    for a, b in zip(leaves, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_get_base_distribution_by_name_class_and_instance():
    assert isinstance(get_base_distribution(2, None), distributions.StandardNormal)
    assert isinstance(get_base_distribution(2, "MVN", var=3.0), distributions.MultivariateNormal)
    assert isinstance(get_base_distribution(2, "uniform"), distributions.MultivariateUniform)
    lars = get_base_distribution(2, "lars", n_neurons=4, T=5)
    assert isinstance(lars, distributions.ResampledGaussian) and lars.T == 5
    assert isinstance(get_base_distribution(2, distributions.MultivariateUniform, low=-1.0), distributions.MultivariateUniform)
    inst = distributions.StandardNormal(2)
    assert get_base_distribution(2, inst) is inst
    with pytest.raises(ValueError, match="Unknown distribution"):
        get_base_distribution(2, "cauchy")


def test_flow_config_takes_distribution_kwargs(tmp_path):
    from nessai_tpu_torch.flowmodel import FlowModel

    fm = FlowModel(dict(n_inputs=2, distribution="mvn", distribution_kwargs=dict(var=2.0)), output=str(tmp_path),
                   rng=np.random.default_rng(0), device="cpu")
    fm.initialise()
    assert isinstance(fm.flow.base, distributions.MultivariateNormal) and fm.flow.base.var == 2.0


def test_lars_flow_model_updates_log_z_every_epoch(tmp_path, monkeypatch):
    """Training a flow on a LARS base moves log_Z after every epoch
    (decay 0.99, 10,000 draws) and takes a final estimate from 50,000
    draws with decay 0, as the JAX package's per-epoch loop does; the
    draws come from the flow model's own generator; end_iteration and
    finalise are the flow's."""
    from nessai_tpu_torch.flowmodel import FlowModel

    calls = []
    update = distributions.ResampledGaussian.update_log_z

    def recording(self, n=10000, decay=0.99, generator=None, z=None):
        calls.append((n, decay, generator is not None))
        return update(self, n, decay, generator, z)

    monkeypatch.setattr(distributions.ResampledGaussian, "update_log_z", recording)
    fm = FlowModel(dict(n_inputs=2, n_blocks=2, n_neurons=8, distribution="lars",
                        distribution_kwargs=dict(n_neurons=8)),
                   dict(max_epochs=4, patience=10), output=str(tmp_path), rng=np.random.default_rng(0), device="cpu")
    history = fm.train(np.random.default_rng(1).normal(size=(300, 2)), save=False)
    assert calls == [(10000, 0.99, True)] * len(history["loss"]) + [(50000, 0.0, True)]
    assert math.isfinite(float(fm.flow.base.log_Z))
    calls.clear()
    fm.end_iteration()
    fm.finalise()
    assert calls == [(10000, 0.99, True), (100000, 0.0, True)]
    # the generator survives a pickle as its state
    import pickle

    clone = pickle.loads(pickle.dumps(fm))
    assert torch.equal(clone.device_generator().get_state(), fm.device_generator().get_state())


def test_unit_gaussian_flow_model_draws_no_device_generator(tmp_path):
    """A flow without a LARS base makes no LARS generator, so its run's
    random streams are those of the flows before LARS was ported."""
    from nessai_tpu_torch.flowmodel import FlowModel

    fm = FlowModel(dict(n_inputs=2, n_blocks=2, n_neurons=4), dict(max_epochs=2), output=str(tmp_path),
                   rng=np.random.default_rng(0), device="cpu")
    fm.train(np.random.default_rng(1).normal(size=(100, 2)), save=False)
    fm.end_iteration()
    fm.finalise()
    assert fm._device_generator is None


@pytest.mark.parametrize(
    "flow",
    [
        dict(ftype="maf"),
        dict(linear_transform="lu", pre_transform="logit", distribution="lars", distribution_kwargs=dict(n_neurons=8)),
        dict(ftype="nsf", tails=None, distribution="uniform", linear_transform=None, num_bins=12),
    ],
    ids=["maf", "lu_logit_lars", "nsf_unit_box"],
)
def test_jax_weight_files_of_the_new_flows_load(flow, tmp_path):
    """The JAX package's weight file (a pickled pytree) of each new flow
    loads into the port's flow through ``state_dict_from_jax_file`` and
    gives the JAX flow model's log-density."""
    from nessai_tpu.flowmodel.base import FlowModel as JaxFlowModel
    from nessai_tpu_torch.flowmodel import FlowModel
    from nessai_tpu_torch.flows.convert import state_dict_from_jax_file

    cfg = dict(n_inputs=3, n_blocks=2, n_neurons=8, **flow)
    jmodel = JaxFlowModel(cfg, output=str(tmp_path / "jax"), rng=np.random.default_rng(0))
    jmodel.initialise()
    jmodel.params = jax.tree.map(jnp.asarray, _perturb(jmodel.params, seed=6))
    path = str(tmp_path / "model.pkl")
    jmodel.save_weights(path)
    model = FlowModel(cfg, output=str(tmp_path / "torch"), device="cpu")
    model.initialise()
    model.flow.load_state_dict(state_dict_from_jax_file(model.flow, path))
    x = np.random.default_rng(2).uniform(0.05, 0.95, size=(300, 3))
    ours, theirs = model.log_prob(x), np.asarray(jmodel.log_prob(x))
    assert np.isfinite(theirs).all()
    np.testing.assert_allclose(ours, theirs, atol=FLOW_ATOL, rtol=FLOW_RTOL)
