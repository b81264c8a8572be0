"""Conditional flows (``context_features``) in the port against the JAX
package, on converted weights: the couplings' nets take ``[x_id,
context]`` in both, so RealNVP and NSF give the same forward, inverse and
log-density for the same numpy contexts; the flow model's ActNorm
initialisation, loss and inference calls with a ``conditional``; the
proposal's ``forward_pass`` and ``backward_pass``; and the flow builders
that users register or pass.

Every JAX conditioner starts with a zero final layer, so the weights are
perturbed with numpy before they are converted. Tolerance: atol and rtol
1e-5 on float32 outputs of order one (as ``tests/test_torch_flows.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.flowmodel import FlowModel as JaxFlowModel
from nessai_tpu.flows import configure_model as jax_configure_model
from nessai_tpu.proposal import FlowProposal as JaxFlowProposal
from nessai_tpu.utils.testing import IntegrationTestModel as JaxModel
from nessai_tpu_torch.experimental.flows import ExternalBijector, get_glasflow_class
from nessai_tpu_torch.flowmodel import FlowModel
from nessai_tpu_torch.flows import (
    Flow,
    configure_model,
    get_flow_class,
    get_native_flow_class,
    params_from_jax,
    params_to_jax,
    register_flow,
)
from nessai_tpu_torch.flows import bijectors as tbij
from nessai_tpu_torch.flows.distributions import StandardNormal
from nessai_tpu_torch.flows.realnvp import build_realnvp_bijector
from nessai_tpu_torch.proposal import FlowProposal
from nessai_tpu_torch.utils.testing import IntegrationTestModel

ATOL = RTOL = 1e-5
CONTEXT = 3


@pytest.fixture(autouse=True)
def _highest_precision():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(previous)


def _perturb(params, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + rng.normal(0.0, scale, a.shape).astype(a.dtype) if np.asarray(a).dtype.kind == "f" else a,
        jax.tree.map(np.asarray, params),
    )


def _close(a, b):
    np.testing.assert_allclose(
        a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        np.asarray(b),
        atol=ATOL,
        rtol=RTOL,
    )


def _one_hot(n, k=CONTEXT, seed=0):
    labels = np.random.default_rng(seed).integers(0, k, n)
    return np.eye(k, dtype=np.float32)[labels]


def _x(n, d, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, d))).astype(np.float32)


def _pair(dims, ftype, net, seed=3, **extra):
    cfg = dict(n_inputs=dims, n_blocks=2, n_neurons=8, n_layers=2, net=net, ftype=ftype,
               context_features=CONTEXT, **extra)
    jflow, jparams, _ = jax_configure_model(dict(cfg, seed=seed))
    p = _perturb(jparams, seed + 1)
    tflow = configure_model(cfg)
    params_from_jax(tflow, p)
    return jflow, jax.tree.map(jnp.asarray, p), tflow, p


@pytest.mark.parametrize("net", ["resnet", "mlp"])
@pytest.mark.parametrize("ftype,dims,scale", [("realnvp", 2, 1.0), ("realnvp", 3, 1.0), ("nsf", 2, 2.0),
                                              ("nsf", 3, 2.0)])
def test_conditional_flow_matches_jax(ftype, dims, scale, net):
    """Forward, inverse, log-prob and the inverse with log q of a
    conditional RealNVP (K1's path) and NSF (K2's path, inputs reaching
    the linear tails) against the JAX flow with the same contexts."""
    jflow, jp, tflow, _ = _pair(dims, ftype, net)
    coupling = next(b for b in tflow.bijector.bijectors if isinstance(b, (tbij.AffineCoupling, tbij.RQSCoupling)))
    first = coupling.net.initial if net == "resnet" else coupling.net.layers[0]
    assert first.in_features == len(coupling.identity_idx) + CONTEXT
    x, c = _x(64, dims, scale=scale), _one_hot(64)
    z_j, lj_j = jflow.forward(jp, x, c)
    xi_j, lji_j = jflow.inverse(jp, x, c)
    lp_j = jflow.log_prob(jp, x, c)
    xt, ct = torch.as_tensor(x), torch.as_tensor(c)
    with torch.no_grad():
        z_t, lj_t = tflow(xt, ct)
        xi_t, lji_t = tflow.inverse(xt, ct)
        lp_t = tflow.log_prob(xt, ct)
        x_lq, lq = tflow.inverse_and_log_prob(xt, ct)
        # the context matters: another label gives another map
        z_other, _ = tflow(xt, torch.roll(ct, 1, dims=1))
    for a, b in ((z_t, z_j), (lj_t, lj_j), (xi_t, xi_j), (lji_t, lji_j), (lp_t, lp_j), (x_lq, xi_j)):
        _close(a, b)
    _close(lq, np.asarray(jflow.base_log_prob(jp, x)) - np.asarray(lji_j))
    assert (z_other - z_t).abs().max() > 1e-3
    # converted weights of the wider first layer go back unchanged
    for a, b in zip(jax.tree.leaves(params_to_jax(tflow)), jax.tree.leaves(_perturb_back(jp))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _perturb_back(jp):
    return jax.tree.map(np.asarray, jp)


def test_conditional_flow_gradient_matches_jax():
    """The loss's gradient in every weight of a conditional RealNVP, the
    training path of K1's backward."""
    jflow, jp, tflow, _ = _pair(2, "realnvp", "resnet", seed=9)
    x, c = _x(50, 2, seed=4), _one_hot(50, seed=5)
    grads_j = jax.grad(lambda p: jflow.loss(p, x, context=c), allow_int=True)(jp)
    loss = -tflow.log_prob(torch.as_tensor(x), torch.as_tensor(c)).mean()
    loss.backward()
    twin = copy.deepcopy(tflow)
    with torch.no_grad():
        for p_twin, p in zip(twin.parameters(), tflow.parameters()):
            p_twin.copy_(p.grad)
    ours = params_to_jax(twin)["bijector"]
    theirs = jax.tree.map(np.asarray, grads_j)["bijector"]
    for b, (a_layer, b_layer) in enumerate(zip(ours, theirs)):
        if "perm" in a_layer:
            continue
        for a, g in zip(jax.tree.leaves(a_layer), jax.tree.leaves(b_layer)):
            np.testing.assert_allclose(a, g, atol=1e-4, rtol=1e-4, err_msg=f"bijector {b}")


def test_maf_takes_and_ignores_context():
    """MAF swallows ``context_features`` and ignores the context, as the
    JAX ``build_maf_bijector(**kwargs)`` does."""
    jflow, jp, tflow, _ = _pair(3, "maf", "resnet")
    x = _x(20, 3)
    with torch.no_grad():
        for c in (None, torch.as_tensor(_one_hot(20))):
            _close(tflow.log_prob(torch.as_tensor(x), c), jflow.log_prob(jp, x, _one_hot(20)))


def _flow_models(tmp_path, ftype="realnvp", seed=0):
    cfg = dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1, ftype=ftype, context_features=CONTEXT)
    jfm = JaxFlowModel(cfg, dict(max_epochs=3), output=str(tmp_path / "jax"), rng=np.random.default_rng(seed))
    jfm.initialise()
    p = _perturb(jfm.params, seed + 1)
    jfm.params = jax.tree.map(jnp.asarray, p)
    tfm = FlowModel(cfg, dict(max_epochs=3), output=str(tmp_path / "torch"), rng=np.random.default_rng(seed),
                    device="cpu")
    tfm.initialise()
    params_from_jax(tfm.flow, p)
    return jfm, tfm


def test_actnorm_init_with_a_conditional_matches_jax(tmp_path):
    jfm, tfm = _flow_models(tmp_path)
    x, c = _x(300, 2, seed=6, scale=3.0) + 1.0, _one_hot(300, seed=7)
    jfm._maybe_init_actnorm(x, conditional=c)
    tfm._maybe_init_actnorm(x, conditional=c)
    ours = params_to_jax(tfm.flow)["bijector"]
    theirs = jax.tree.map(np.asarray, jfm.params)["bijector"]
    n_actnorm = 0
    for a, b in zip(ours, theirs):
        if "log_scale" in a:
            n_actnorm += 1
            _close(a["log_scale"], b["log_scale"])
            _close(a["shift"], b["shift"])
    assert n_actnorm == 2
    # the second ActNorm saw activations that depend on the context
    twin = FlowModel(dict(n_inputs=2, n_blocks=2, n_neurons=8, n_layers=1, context_features=CONTEXT), None,
                     output=str(tmp_path / "twin"), rng=np.random.default_rng(0), device="cpu")
    twin.initialise()
    params_from_jax(twin.flow, jax.tree.map(np.asarray, _perturb(jfm.params, 1)))
    twin._maybe_init_actnorm(x, conditional=np.roll(c, 1, axis=1))
    assert not np.allclose(params_to_jax(twin.flow)["bijector"][-1]["shift"], ours[-1]["shift"])


@pytest.mark.parametrize("ftype", ["realnvp", "nsf"])
def test_flow_model_inference_with_a_conditional_matches_jax(tmp_path, ftype):
    """``forward_and_log_prob``, ``forward``, ``inverse``,
    ``inverse_and_log_prob`` and ``log_prob`` with a ``conditional``
    (numpy in, float64 numpy out) against the JAX flow model's; ``sample``
    draws finite points of the right shape."""
    jfm, tfm = _flow_models(tmp_path, ftype)
    x, c = _x(40, 2, seed=8), _one_hot(40, seed=9)
    for name in ("forward_and_log_prob", "forward", "inverse", "inverse_and_log_prob"):
        ours = getattr(tfm, name)(x, conditional=c)
        theirs = getattr(jfm, name)(x, conditional=c)
        assert all(a.dtype == np.float64 for a in ours)
        for a, b in zip(ours, theirs):
            _close(a, b)
    _close(tfm.log_prob(x, conditional=c), jfm.log_prob(x, conditional=c))
    samples = tfm.sample(40, conditional=c)
    assert samples.shape == (40, 2) and np.isfinite(samples).all()


def test_conditional_training_shuffles_the_conditional_with_the_samples(tmp_path):
    """``prep_data`` carries each row's conditional with it through the
    shuffle and the split, and the first epoch's loss is the JAX flow's
    loss on the same batch."""
    jfm, tfm = _flow_models(tmp_path)
    x, c = _x(100, 2, seed=10), _one_hot(100, seed=11)
    batches, val, w_b, w_v, c_batches, c_val = tfm.prep_data(x, 0.2, batch_size=30, conditional=c)
    assert w_b is None and w_v is None
    assert [len(b) for b in c_batches] == [len(b) for b in batches] == [30, 30, 20]
    lookup = {tuple(row): tuple(ctx) for row, ctx in zip(x.tolist(), c.tolist())}
    for rows, ctxs in list(zip(batches, c_batches)) + [(val, c_val)]:
        for row, ctx in zip(rows.tolist(), ctxs.tolist()):
            assert lookup[tuple(row)] == tuple(ctx)
    with torch.no_grad():
        ours = tfm._loss(batches[0], None, c_batches[0])
    theirs = jfm.flow.loss(jfm.params, batches[0].numpy(), context=c_batches[0].numpy())
    _close(ours, theirs)
    history = tfm.train(x, conditional=c, max_epochs=3, save=False)
    assert len(history["loss"]) == 3 and np.isfinite(history["loss"]).all()
    with pytest.raises(ValueError, match="conditional rows"):
        tfm.prep_data(x, 0.2, conditional=c[:50])


def _proposals(tmp_path):
    """The port's and the JAX package's flow proposals with the same
    fitted reparameterisations and converted, perturbed weights."""
    common = dict(poolsize=100, flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1), plot=False)
    jmodel, tmodel = JaxModel(2), IntegrationTestModel(2)
    jmodel.set_rng(np.random.default_rng(0))
    tmodel.set_rng(np.random.default_rng(0))
    jp = JaxFlowProposal(jmodel, output=str(tmp_path / "jax"), rng=np.random.default_rng(0), **common)
    tp = FlowProposal(tmodel, output=str(tmp_path / "torch"), rng=np.random.default_rng(0), device="cpu", **common)
    for p in (jp, tp):
        p.initialise()
    x = tp.model.new_point(200)
    jx = jp.model.new_point(200)
    for name in tp.model.names:
        jx[name] = x[name]
    tp._reparameterisation.update(tp._convert_to_x(x))
    jp._reparameterisation.update(jp._convert_to_x(jx))
    params = _perturb(jp.flow.params, 2)
    jp.flow.params = jax.tree.map(jnp.asarray, params)
    params_from_jax(tp.flow.flow, params)
    return jp, tp, x, jx


def test_forward_and_backward_pass_match_jax(tmp_path):
    """``forward_pass`` (reparameterisation and flow, with log q and the
    Jacobian) and ``backward_pass`` (the bound filter, ``return_z``) of
    the port against the JAX package's."""
    jp, tp, x, jx = _proposals(tmp_path)
    z_t, lq_t = tp.forward_pass(tp._convert_to_x(x))
    z_j, lq_j = jp.forward_pass(jp._convert_to_x(jx))
    _close(z_t, z_j)
    _close(lq_t, lq_j)
    z = 3.0 * _x(300, 2, seed=12).astype(np.float64)
    x_t, lq_t, zk_t = tp.backward_pass(z, return_z=True)
    x_j, lq_j, zk_j = jp.backward_pass(z, return_z=True)
    assert 0 < len(x_t) < len(z)
    np.testing.assert_array_equal(zk_t, zk_j)
    for name in tp.model.names:
        _close(x_t[name], x_j[name])
    _close(lq_t, lq_j)
    x_t, lq_t = tp.backward_pass(z, discard_nans=False)
    assert len(x_t) == len(zk_j)


def test_register_flow_and_the_flow_key(tmp_path):
    """A registered builder by its ``ftype``, a callable ``flow`` key
    (overriding ``ftype``) and a builder that returns a whole flow."""
    calls = []

    def builder(dim, n_blocks=2, n_neurons=4, n_layers=1, generator=None, **kwargs):
        calls.append((dim, kwargs.get("context_features")))
        return build_realnvp_bijector(dim, n_blocks=n_blocks, n_neurons=n_neurons, n_layers=n_layers,
                                      context_features=kwargs.get("context_features"), generator=generator)

    register_flow("My-Test-Flow", builder)
    assert get_native_flow_class("my-test-flow") is get_flow_class("MY-TEST-FLOW") is builder
    fm = FlowModel(dict(n_inputs=2, ftype="my-test-flow", n_blocks=2, n_neurons=4),
                   dict(max_epochs=3, batch_size=32, patience=2), output=str(tmp_path),
                   rng=np.random.default_rng(0), device="cpu")
    history = fm.train(_x(64, 2), save=False)
    assert np.isfinite(history["loss"]).all() and calls == [(2, None)]
    flow = configure_model(dict(n_inputs=3, flow=builder, context_features=2))
    assert calls[-1] == (3, 2) and isinstance(flow, Flow) and not flow.training
    whole = configure_model(dict(n_inputs=2, flow=lambda dim, **kw: Flow(builder(dim, **kw), StandardNormal(dim), dim)))
    assert isinstance(whole.bijector, tbij.Chain)
    with pytest.raises(TypeError):
        register_flow("bad", "not-callable")
    with pytest.raises(TypeError):
        configure_model(dict(n_inputs=3, flow="not-callable"))
    with pytest.raises(RuntimeError, match="either 'flow' or 'ftype'"):
        configure_model(dict(n_inputs=3, ftype=None))
    assert get_glasflow_class("glasflow-realnvp") is get_native_flow_class("glasflow-realnvp")
    with pytest.raises(ValueError, match="missing from name"):
        get_glasflow_class("realnvp")
    with pytest.raises(ValueError, match="not a known glasflow flow"):
        get_glasflow_class("glasflow-doesnotexist")


def test_external_bijector_trains_its_parameters(tmp_path):
    """``ExternalBijector``: the parameters of ``init_fn`` are the
    module's (in its state dict, updated by training), the functions get
    them with the context, and the wrapper sits in a chain."""
    seen = []

    def init_fn(generator):
        return {"log_a": torch.zeros(()), "b": torch.ones(())}

    def forward_fn(params, x, context):
        seen.append(context is None)
        return torch.exp(params["log_a"]) * x + params["b"], params["log_a"] * x.shape[-1] * torch.ones(len(x))

    def inverse_fn(params, z, context):
        return (z - params["b"]) * torch.exp(-params["log_a"]), -params["log_a"] * z.shape[-1] * torch.ones(len(z))

    def builder(dim, generator=None, **kwargs):
        return tbij.Chain([ExternalBijector(init_fn, forward_fn, inverse_fn, generator)])

    with pytest.raises(TypeError):
        ExternalBijector(init_fn, forward_fn, "no")
    fm = FlowModel(dict(n_inputs=2, flow=builder), dict(max_epochs=20, batch_size=64, patience=50, lr=0.05),
                   output=str(tmp_path), rng=np.random.default_rng(1), device="cpu")
    fm.initialise()
    assert set(fm.flow.state_dict()) == {"bijector.bijectors.0.params.log_a", "bijector.bijectors.0.params.b"}
    fm.train(_x(256, 2, seed=3, scale=3.0) + 2.0, save=False)
    state = fm.flow.state_dict()
    # whitening data of scale 3 about 2: a -> 1/3, b -> -2/3
    assert state["bijector.bijectors.0.params.log_a"] < -0.2 and state["bijector.bijectors.0.params.b"] < 0.5
    x, log_j = fm.inverse(*fm.forward(_x(5, 2)))
    _close(x, _x(5, 2))
    assert all(seen)
