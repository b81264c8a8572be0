"""The port's flows against the JAX package's, on converted weights.

Every JAX conditioner starts with a zero final layer (every coupling is
the identity), so the weights are perturbed with numpy before they are
converted: equality on fresh weights would prove nothing.
Tolerance: atol 1e-5 on float32 outputs of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.flows import bijectors as jbij
from nessai_tpu.flows import configure_model as jax_configure_model
from nessai_tpu.flows.nets import apply_mlp, apply_resnet, init_mlp, init_resnet
from nessai_tpu_torch.flows import bijectors as tbij
from nessai_tpu_torch.flows import configure_model, params_from_jax, params_to_jax
from nessai_tpu_torch.flows.convert import _net_from
from nessai_tpu_torch.flows.nets import MLP, ResNet

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")


def _perturb(params, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (
            a + rng.normal(0.0, scale, a.shape).astype(a.dtype)
            if np.asarray(a).dtype.kind == "f"
            else np.asarray(a)
        ),
        jax.tree.map(np.asarray, params),
    )


def _x(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(
        a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b),
        atol=ATOL,
        rtol=1e-5,
    )


@pytest.mark.parametrize("net", ["resnet", "mlp"])
@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
def test_conditioners(net, activation):
    key = jax.random.PRNGKey(1)
    if net == "resnet":
        p = _perturb(init_resnet(key, 3, 4, 8, n_blocks=2), 2)
        module = ResNet(3, 4, 8, 2, activation)
        ref = apply_resnet(jax.tree.map(jnp.asarray, p), _x(50, 3), activation=activation)
    else:
        p = _perturb(init_mlp(key, 3, 4, 8, 2), 2)
        module = MLP(3, 4, 8, 2, activation)
        ref = apply_mlp(jax.tree.map(jnp.asarray, p), _x(50, 3), activation=activation)
    with torch.no_grad():
        _net_from(module, p)
        _close(module(torch.as_tensor(_x(50, 3))), ref)


@pytest.mark.parametrize("volume_preserving", [False, True])
@pytest.mark.parametrize("mask", [[1, 0], [0, 1, 1], [1, 0, 1, 0]])
def test_affine_coupling(mask, volume_preserving):
    d = len(mask)
    jb = jbij.AffineCoupling(mask, n_neurons=6, n_layers=2, volume_preserving=volume_preserving)
    p = _perturb(jb.init(jax.random.PRNGKey(3)), 4)
    tb = tbij.AffineCoupling(mask, n_neurons=6, n_layers=2, volume_preserving=volume_preserving)
    with torch.no_grad():
        _net_from(tb.net, p["net"])
    jp = jax.tree.map(jnp.asarray, p)
    x = _x(40, d, seed=5)
    z_j, ld_j = jb.forward(jp, x)
    x_j, ldi_j = jb.inverse(jp, x)
    with torch.no_grad():
        z_t, ld_t = tb(torch.as_tensor(x))
        x_t, ldi_t = tb.inverse(torch.as_tensor(x))
        back, _ = tb.inverse(z_t)
    for a, b in ((z_t, z_j), (ld_t, ld_j), (x_t, x_j), (ldi_t, ldi_j)):
        _close(a, b)
    _close(back, x)


def test_actnorm_and_permutation():
    x = _x(30, 3, seed=6)
    an_j = jbij.ActNorm(3)
    p = {"log_scale": np.array([0.2, -0.4, 0.1], np.float32), "shift": np.array([1.0, -2.0, 0.5], np.float32)}
    an_t = tbij.ActNorm(3)
    with torch.no_grad():
        an_t.log_scale.copy_(torch.as_tensor(p["log_scale"]))
        an_t.shift.copy_(torch.as_tensor(p["shift"]))
    for method in ("forward", "inverse"):
        out_j = getattr(an_j, method)(p, x)
        with torch.no_grad():
            out_t = getattr(an_t, method)(torch.as_tensor(x))
        for a, b in zip(out_t, out_j):
            _close(a, b)
    perm = [2, 0, 1]
    pp_j = jbij.Permutation(3, permutation=perm)
    pj = pp_j.init(jax.random.PRNGKey(0))
    pp_t = tbij.Permutation(3, permutation=perm)
    for method in ("forward", "inverse"):
        a, la = getattr(pp_t, method)(torch.as_tensor(x))
        b, lb = getattr(pp_j, method)(pj, x)
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(la.numpy(), np.asarray(lb))


def test_chain_order():
    x = _x(20, 2, seed=7)
    chain_t = tbij.Chain([tbij.Permutation(2, permutation=[1, 0]), tbij.ActNorm(2)])
    with torch.no_grad():
        chain_t.bijectors[1].shift.fill_(1.0)
        z, ld = chain_t(torch.as_tensor(x))
        back, ld_inv = chain_t.inverse(z)
    np.testing.assert_allclose(z.numpy(), x[:, ::-1] + 1.0, atol=1e-7)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-6)
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=1e-7)


def _pair(dims, n_blocks, n_neurons=4, n_layers=2, net="resnet", seed=11, **extra):
    cfg = dict(n_inputs=dims, n_blocks=n_blocks, n_neurons=n_neurons, n_layers=n_layers, net=net, **extra)
    jflow, jparams, _ = jax_configure_model(dict(cfg, seed=seed))
    p = _perturb(jparams, seed + 1, scale=0.2)
    tflow = configure_model(cfg)
    params_from_jax(tflow, p)
    return jflow, jax.tree.map(jnp.asarray, p), tflow, p


@pytest.mark.parametrize(
    "dims,n_blocks,net",
    [(2, 2, "resnet"), (2, 4, "resnet"), (4, 3, "resnet"), (4, 2, "mlp")],
)
def test_realnvp_matches_jax(dims, n_blocks, net):
    jflow, jp, tflow, _ = _pair(dims, n_blocks, net=net)
    x = _x(64, dims, seed=dims + n_blocks)
    z_j, lj_j = jflow.forward(jp, x)
    xi_j, lji_j = jflow.inverse(jp, x)
    lp_j = jflow.log_prob(jp, x)
    with torch.no_grad():
        xt = torch.as_tensor(x)
        z_t, lj_t = tflow(xt)
        xi_t, lji_t = tflow.inverse(xt)
        lp_t = tflow.log_prob(xt)
        x_lp_t, lq_t = tflow.inverse_and_log_prob(xt)
    for a, b in ((z_t, z_j), (lj_t, lj_j), (xi_t, xi_j), (lji_t, lji_j), (lp_t, lp_j)):
        _close(a, b)
    _close(x_lp_t, xi_j)
    _close(lq_t, np.asarray(jflow.base_log_prob(jp, x)) - np.asarray(lji_j))


@pytest.mark.parametrize(
    "dims,n_blocks,net,num_bins",
    [(2, 4, "resnet", 8), (3, 2, "resnet", 4), (4, 2, "mlp", 8)],
)
def test_nsf_matches_jax(dims, n_blocks, net, num_bins):
    """The neural spline flow (no ActNorm, linear tails) on converted,
    perturbed weights: the splines are far from the identity, and inputs
    of scale 2 reach the linear tails beyond 5."""
    jflow, jp, tflow, _ = _pair(
        dims, n_blocks, net=net, ftype="nsf", num_bins=num_bins, seed=21
    )
    assert any(isinstance(b, tbij.RQSCoupling) for b in tflow.bijector.bijectors)
    assert not any(isinstance(b, tbij.ActNorm) for b in tflow.bijector.bijectors)
    x = 2.0 * _x(64, dims, seed=dims + n_blocks)
    z_j, lj_j = jflow.forward(jp, x)
    xi_j, lji_j = jflow.inverse(jp, x)
    lp_j = jflow.log_prob(jp, x)
    with torch.no_grad():
        xt = torch.as_tensor(x)
        z_t, lj_t = tflow(xt)
        xi_t, lji_t = tflow.inverse(xt)
        lp_t = tflow.log_prob(xt)
        x_lp_t, lq_t = tflow.inverse_and_log_prob(xt)
    for a, b in ((z_t, z_j), (lj_t, lj_j), (xi_t, xi_j), (lji_t, lji_j), (lp_t, lp_j)):
        _close(a, b)
    _close(x_lp_t, xi_j)
    _close(lq_t, np.asarray(jflow.base_log_prob(jp, x)) - np.asarray(lji_j))


@pytest.mark.parametrize("ftype", ["realnvp", "nsf"])
@pytest.mark.parametrize("net", ["resnet", "mlp"])
def test_converter_round_trip_is_exact(net, ftype):
    _, _, tflow, p = _pair(3, 3, net=net, ftype=ftype)
    back = params_to_jax(tflow)
    leaves_a, tree_a = jax.tree.flatten(back)
    leaves_b, tree_b = jax.tree.flatten(p)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_port_flow_init_starts_at_identity_couplings():
    flow = configure_model(dict(n_inputs=2, n_blocks=4, n_neurons=4, n_layers=2, seed=3))
    x = torch.as_tensor(_x(10, 2))
    with torch.no_grad():
        z, log_j = flow(x)
    perm = x
    for b in flow.bijector.bijectors:
        if isinstance(b, tbij.Permutation):
            perm = perm[:, b.perm]
    np.testing.assert_allclose(z.numpy(), perm.numpy(), atol=1e-7)
    np.testing.assert_allclose(log_j.numpy(), 0.0, atol=1e-7)


def test_nsf_init_is_the_identity_spline():
    flow = configure_model(dict(n_inputs=3, n_blocks=3, n_neurons=4, ftype="nsf", seed=3))
    x = torch.as_tensor(2.0 * _x(10, 3))
    with torch.no_grad():
        z, log_j = flow(x)
    perm = x
    for b in flow.bijector.bijectors:
        if isinstance(b, tbij.Permutation):
            perm = perm[:, b.perm]
    np.testing.assert_allclose(z.numpy(), perm.numpy(), atol=1e-6)
    np.testing.assert_allclose(log_j.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("ftype", ["nsf", "spline", "rq-nsf", "glasflow-nsf"])
def test_nsf_names_build_the_jax_layout(ftype):
    """Each spline name builds [Permutation, RQSCoupling] per block, as
    the JAX package does, with a conditioner of n_tr * (3K - 1) outputs."""
    cfg = dict(n_inputs=2, n_blocks=4, n_neurons="auto", n_layers=2, ftype=ftype)
    tflow = configure_model(cfg)
    jflow, _, _ = jax_configure_model(cfg)
    assert [type(b).__name__ for b in tflow.bijector.bijectors] == [
        type(b).__name__ for b in jflow.bijector.bijectors
    ]
    coupling = tflow.bijector.bijectors[1]
    assert coupling.num_bins == 8 and coupling.tail_bound == 5.0 and coupling.tails == "linear"
    assert coupling.net.final.out_features == 1 * (3 * 8 - 1)


def test_unknown_flow_options_raise():
    with pytest.raises(ValueError, match="Unknown flow"):
        configure_model(dict(n_inputs=2, ftype="nope"))
    with pytest.raises(ValueError, match="Unknown linear transform"):
        configure_model(dict(n_inputs=2, ftype="nsf", linear_transform="householder"))
    with pytest.raises(ValueError, match="Unknown pre-transform"):
        configure_model(dict(n_inputs=2, ftype="nsf", pre_transform="tanh"))
    with pytest.raises(ValueError, match="Unknown distribution"):
        configure_model(dict(n_inputs=2, distribution="cauchy"))
    # a context no longer raises: the couplings' nets take [x_id, context]
    flow = configure_model(dict(n_inputs=2, context_features=3))
    assert flow.bijector.bijectors[1].net.initial.in_features == 1 + 3
    context = torch.eye(3)[torch.tensor([0, 2, 1, 0])]
    z, log_j = flow(torch.as_tensor(_x(4, 2)), context)
    x, log_j_inv = flow.inverse(z, context)
    _close(x, torch.as_tensor(_x(4, 2)))
    _close(log_j, -log_j_inv)


def test_realnvp_options_match_jax_layout():
    """``linear_transform=None`` and ``batch_norm_between_layers=False``
    drop the permutations and the ActNorms, as in the JAX package."""
    cfg = dict(
        n_inputs=2, n_blocks=2, n_neurons=4, linear_transform=None, batch_norm_between_layers=False
    )
    tflow = configure_model(cfg)
    jflow, _, _ = jax_configure_model(cfg)
    assert [type(b).__name__ for b in tflow.bijector.bijectors] == [
        type(b).__name__ for b in jflow.bijector.bijectors
    ] == ["AffineCoupling", "AffineCoupling"]


def test_realnvp_flagship_initial_state_is_pinned():
    """The RealNVP flagship's flow draws its permutations and weights from
    the generator in the same order as before the neural-spline builders
    shared its block loop (the seeded GPU run's logZ rests on it)."""
    import hashlib

    flow = configure_model(dict(n_inputs=2, n_blocks=4, n_neurons="auto", n_layers=2, seed=1234))
    digest = hashlib.sha256()
    for k, v in flow.state_dict().items():
        digest.update(k.encode())
        digest.update(v.cpu().numpy().tobytes())
    assert digest.hexdigest() == (
        "37a7dd34111c8c13f025d810361bae02ba8d70fba0849a550adf327b134b2203"
    )
