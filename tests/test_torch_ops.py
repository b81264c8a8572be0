"""The port's affine-coupling kernel module against the JAX package's
Pallas kernel (interpret mode on the CPU) and its jnp reference.

On the CPU the wrapper runs the plain PyTorch version through the
kernel's ``autograd.Function``, so these tests cover the plain version,
the closed-form backward and the input checks; the CUDA kernel itself is
held against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``). Tolerances as in ``tests/test_ops.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.ops.coupling_pallas import (
    _reference_transform,
    affine_coupling_pallas_vjp,
    affine_coupling_transform,
)
from nessai_tpu_torch.ops.coupling import (
    AffineCouplingFunction,
    affine_coupling,
    affine_coupling_plain,
)


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed + 100 * n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    raw_s = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    t = rng.standard_normal((n, d)).astype(np.float32)
    return x, raw_s, t


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("n", [13, 200, 1029])
def test_plain_matches_pallas_and_reference(n, d, inverse):
    x, raw_s, t = _inputs(n, d)
    y_p, ld_p = affine_coupling_transform(x, raw_s, t, inverse=inverse, interpret=True)
    y_r, ld_r = _reference_transform(x, raw_s, t, inverse, 5.0)
    y, ld = affine_coupling_plain(*_t(x, raw_s, t), inverse=inverse)
    y_w, ld_w = affine_coupling(*_t(x, raw_s, t), inverse=inverse)
    for ref_y, ref_ld in ((y_p, ld_p), (y_r, ld_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), atol=1e-5, rtol=1e-5)
    assert torch.equal(y_w, y) and torch.equal(ld_w, ld)


@pytest.mark.parametrize("d", [1, 3, 8])
def test_round_trip(d):
    x, raw_s, t = _t(*_inputs(200, d, seed=1))
    z, ld_f = affine_coupling(x, raw_s, t)
    x2, ld_i = affine_coupling(z, raw_s, t, inverse=True)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=1e-5)
    np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,d", [(8, 2), (37, 3)])
def test_gradients_match_jax(n, d, inverse):
    x, raw_s, t = _inputs(n, d, seed=2)
    rng = np.random.default_rng(5)
    w_y = rng.standard_normal((n, d)).astype(np.float32)
    w_ld = rng.standard_normal(n).astype(np.float32)

    def loss_jax(a, b, c):
        y, ld = affine_coupling_pallas_vjp(a, b, c, inverse, 5.0, True)
        return jnp.sum(y * w_y) + jnp.sum(ld * w_ld)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(raw_s), jnp.asarray(t)
    )
    args = [a.requires_grad_(True) for a in _t(x, raw_s, t)]
    y, ld = AffineCouplingFunction.apply(*args, inverse, 5.0)
    (torch.sum(y * torch.as_tensor(w_y)) + torch.sum(ld * torch.as_tensor(w_ld))).backward()
    for a, g in zip(args, g_jax):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def test_gradient_of_one_output_only():
    x, raw_s, t = (a.requires_grad_(True) for a in _t(*_inputs(10, 2, seed=3)))
    _, ld = affine_coupling(x, raw_s, t)
    ld.sum().backward()
    s = torch.tanh(raw_s.detach() / 5.0)
    np.testing.assert_allclose(raw_s.grad.numpy(), (1 - s**2).numpy(), rtol=1e-6)
    assert torch.count_nonzero(x.grad) == 0 and torch.count_nonzero(t.grad) == 0


def test_wrapper_rejects_bad_input():
    x, raw_s, t = _t(*_inputs(5, 2))
    with pytest.raises(TypeError):
        affine_coupling(x.double(), raw_s.double(), t.double())
    with pytest.raises(ValueError):
        affine_coupling(x, raw_s[:, :1], t)
    with pytest.raises(ValueError):
        affine_coupling(x[0], raw_s[0], t[0])
    with pytest.raises(RuntimeError, match="no kernel"):
        affine_coupling(x.to("meta"), raw_s.to("meta"), t.to("meta"))


def test_wrapper_accepts_non_contiguous_input():
    x, raw_s, t = _t(*_inputs(6, 4))
    y, ld = affine_coupling(x[:, ::2], raw_s[:, ::2], t[:, ::2])
    y_ref, ld_ref = affine_coupling_plain(x[:, ::2], raw_s[:, ::2], t[:, ::2])
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)


# The coupling layer: the fused op (column split, affine map, scatter and
# log-determinant) against the JAX package's AffineCoupling on converted
# weights, perturbed so that the coupling is not the identity.

LAYER_MASKS = [[1, 0], [0, 1, 1], [1, 0, 0, 1, 0]]


def _jax_coupling(mask, seed=3):
    from nessai_tpu.flows import bijectors as jbij
    from nessai_tpu_torch.flows import bijectors as tbij
    from nessai_tpu_torch.flows.convert import _net_from

    jb = jbij.AffineCoupling(mask, n_neurons=6, n_layers=2)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0.0, 0.3, np.shape(a)).astype(np.float32),
        jb.init(jax.random.PRNGKey(seed)),
    )
    tb = tbij.AffineCoupling(mask, n_neurons=6, n_layers=2)
    with torch.no_grad():
        _net_from(tb.net, params["net"])
    return jb, jax.tree.map(jnp.asarray, params), tb


def _layer_args(tb, x):
    return x, tb.net(x[:, tb.identity_idx]), tb.transform_idx32


def _x_layer(n, d, seed=11):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mask", LAYER_MASKS)
def test_layer_plain_and_function_match_jax_coupling(mask, inverse):
    from nessai_tpu_torch.ops.coupling import (
        AffineCouplingLayerFunction,
        affine_coupling_layer_plain,
    )

    jb, jp, tb = _jax_coupling(mask)
    x = _x_layer(40, len(mask))
    y_j, ld_j = (jb.inverse if inverse else jb.forward)(jp, x)
    with torch.no_grad():
        args = _layer_args(tb, torch.as_tensor(x))
        y_p, ld_p = affine_coupling_layer_plain(*args, inverse)
        y_f, ld_f = AffineCouplingLayerFunction.apply(*args, inverse, 5.0)
        y_m, ld_m = (tb.inverse if inverse else tb)(torch.as_tensor(x))
    for y, ld in ((y_p, ld_p), (y_f, ld_f), (y_m, ld_m)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=1e-5, rtol=1e-5)
    # identity columns are copied exactly
    id_cols = np.flatnonzero(np.asarray(mask) > 0)
    assert np.array_equal(y_f.numpy()[:, id_cols], x[:, id_cols])


def _grads_like_jax(net):
    """The conditioner's parameter gradients in the JAX package's layout."""
    from nessai_tpu_torch.flows.nets import ResNet

    def dense(layer):
        return {"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()}

    assert isinstance(net, ResNet)
    return {
        "initial": dense(net.initial),
        "blocks": [{"l1": dense(b.l1), "l2": dense(b.l2)} for b in net.blocks],
        "final": dense(net.final),
    }


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mask", LAYER_MASKS)
def test_layer_gradients_match_jax_grad_and_pallas_vjp(mask, inverse):
    """The layer's gradients in x and in the conditioner's parameters
    against ``jax.grad`` of the JAX coupling (jnp path) and of the Pallas
    path (``affine_coupling_pallas_vjp`` in interpret mode between the
    JAX package's own split and scatter)."""
    jb, jp, tb = _jax_coupling(mask, seed=5)
    n, d = 24, len(mask)
    x = _x_layer(n, d, seed=12)
    rng = np.random.default_rng(13)
    w_y = rng.standard_normal((n, d)).astype(np.float32)
    w_ld = rng.standard_normal(n).astype(np.float32)

    def loss_jnp(params, xx):
        y, ld = (jb.inverse if inverse else jb.forward)(params, xx)
        return jnp.sum(y * w_y) + jnp.sum(ld * w_ld)

    def loss_pallas(params, xx):
        x_id = xx[..., list(jb.identity_idx)]
        x_tr = xx[..., list(jb.transform_idx)]
        raw_s, t = jb._raw_scale_shift(params, x_id, None)
        y_tr, ld = affine_coupling_pallas_vjp(x_tr, raw_s, t, inverse, 5.0, True)
        y = jb._scatter(x_id, y_tr, xx.dtype)
        return jnp.sum(y * w_y) + jnp.sum(ld * w_ld)

    xt = torch.as_tensor(x).requires_grad_(True)
    y, ld = (tb.inverse if inverse else tb)(xt)
    (torch.sum(y * torch.as_tensor(w_y)) + torch.sum(ld * torch.as_tensor(w_ld))).backward()
    ours = _grads_like_jax(tb.net)
    for loss in (loss_jnp, loss_pallas):
        g_p, g_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-4, atol=1e-4)
        ref_leaves, ref_tree = jax.tree.flatten(g_p["net"])
        our_leaves, our_tree = jax.tree.flatten(ours)
        assert ref_tree == our_tree
        for a, b in zip(our_leaves, ref_leaves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mask", LAYER_MASKS)
def test_layer_function_backward_matches_autograd_of_plain(mask, inverse):
    from nessai_tpu_torch.ops.coupling import (
        AffineCouplingLayerFunction,
        affine_coupling_layer_plain,
    )

    n, d = 30, len(mask)
    tidx = torch.as_tensor(np.flatnonzero(np.asarray(mask) <= 0), dtype=torch.int32)
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    out = torch.as_tensor(2.0 * rng.standard_normal((n, 2 * tidx.numel())), dtype=torch.float32)
    w_y = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    w_ld = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    grads = []
    for f in (AffineCouplingLayerFunction.apply, affine_coupling_layer_plain):
        a, b = x.clone().requires_grad_(True), out.clone().requires_grad_(True)
        y, ld = f(a, b, tidx, inverse, 5.0)
        grads.append(torch.autograd.grad((y, ld), (a, b), (w_y, w_ld)))
    for g_f, g_p in zip(*grads):
        torch.testing.assert_close(g_f, g_p, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("used", ["y", "ld"])
def test_layer_with_one_output_unused(used):
    """A cotangent that is None (an output unused) gives the gradient of
    the other output alone."""
    from nessai_tpu_torch.ops.coupling import affine_coupling_layer, affine_coupling_layer_plain

    mask = [1, 0, 0, 1, 0]
    tidx = torch.as_tensor(np.flatnonzero(np.asarray(mask) <= 0), dtype=torch.int32)
    rng = np.random.default_rng(22)
    x = torch.as_tensor(rng.standard_normal((9, 5)), dtype=torch.float32)
    out = torch.as_tensor(rng.standard_normal((9, 6)), dtype=torch.float32)
    grads = []
    for f in (affine_coupling_layer, affine_coupling_layer_plain):
        a, b = x.clone().requires_grad_(True), out.clone().requires_grad_(True)
        y, ld = f(a, b, tidx)
        (y.square().sum() if used == "y" else ld.sum()).backward()
        # the plain version's ld does not reach x: no gradient is zeros
        grads.append(tuple(torch.zeros_like(v) if v.grad is None else v.grad for v in (a, b)))
    for g_f, g_p in zip(*grads):
        torch.testing.assert_close(g_f, g_p, atol=1e-6, rtol=1e-5)
    if used == "ld":
        # no y cotangent: x and t get no gradient
        assert torch.count_nonzero(grads[0][0]) == 0
        assert torch.count_nonzero(grads[0][1][:, 3:]) == 0


def test_layer_x_without_gradient():
    from nessai_tpu_torch.ops.coupling import affine_coupling_layer

    tidx = torch.tensor([1], dtype=torch.int32)
    x = torch.randn(7, 2)
    out = torch.randn(7, 2, requires_grad=True)
    y, ld = affine_coupling_layer(x, out, tidx)
    (y.sum() + ld.sum()).backward()
    assert out.grad is not None and x.grad is None


def test_layer_wrapper_rejects_bad_input_and_takes_strided_input():
    from nessai_tpu_torch.ops.coupling import affine_coupling_layer, affine_coupling_layer_plain

    x = torch.randn(6, 8)
    out = torch.randn(6, 4)
    tidx = torch.tensor([1, 3], dtype=torch.int32)
    with pytest.raises(TypeError):
        affine_coupling_layer(x, out, tidx.long())
    with pytest.raises(TypeError):
        affine_coupling_layer(x.double(), out.double(), tidx)
    with pytest.raises(ValueError, match="width"):
        affine_coupling_layer(x, out[:, :3], tidx)
    with pytest.raises(ValueError, match="rows"):
        affine_coupling_layer(x, out[:5], tidx)
    with pytest.raises(ValueError, match="transformed columns"):
        affine_coupling_layer(x, out[:, :0], tidx[:0])
    with pytest.raises(RuntimeError, match="no kernel"):
        affine_coupling_layer(x.to("meta"), out.to("meta"), tidx.to("meta"))
    # a non-contiguous x (every other column) and out (every other row)
    wide = torch.randn(12, 8)
    y, ld = affine_coupling_layer(x[:, ::2], wide[::2, :4], tidx)
    y_ref, ld_ref = affine_coupling_layer_plain(x[:, ::2].contiguous(), wide[::2, :4].contiguous(), tidx)
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)


def test_volume_preserving_coupling_keeps_the_split(monkeypatch):
    """The additive coupling does not go through the fused op."""
    from nessai_tpu_torch.flows import bijectors as tbij

    def refuse(*args, **kwargs):
        raise AssertionError("the volume-preserving coupling called the fused layer")

    monkeypatch.setattr(tbij, "affine_coupling_layer", refuse)
    tb = tbij.AffineCoupling([1, 0, 1], n_neurons=4, volume_preserving=True)
    x = torch.randn(5, 3)
    with torch.no_grad():
        for p in tb.parameters():
            p.add_(0.3 * torch.randn(p.shape))
        z, ld = tb(x)
        back, ld_i = tb.inverse(z)
    assert torch.equal(ld, torch.zeros(5)) and torch.equal(ld_i, torch.zeros(5))
    torch.testing.assert_close(back, x, atol=1e-6, rtol=0)
    assert torch.equal(z[:, [0, 2]], x[:, [0, 2]])


def test_layer_on_cpu_launches_nothing():
    from nessai_tpu_torch.ops import coupling

    coupling.affine_coupling.launches = coupling.affine_coupling.backward_launches = 0
    x = torch.randn(16, 2, requires_grad=True)
    out = torch.randn(16, 2, requires_grad=True)
    y, ld = coupling.affine_coupling_layer(x, out, torch.tensor([0], dtype=torch.int32))
    (y.sum() + ld.sum()).backward()
    y_ref, ld_ref = coupling.affine_coupling_layer_plain(x, out, torch.tensor([0], dtype=torch.int32))
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
    assert coupling.affine_coupling.launches == 0 and coupling.affine_coupling.backward_launches == 0


def test_compare_tool_loads_another_checkout_beside_this_one():
    """``utils/compare_k1.py`` loads a second copy of the package (here
    this checkout itself) under its own name, with its own modules."""
    import importlib
    import sys
    from pathlib import Path

    from nessai_tpu_torch.ops import coupling
    from nessai_tpu_torch.utils.compare_k1 import load_other

    root = Path(coupling.__file__).resolve().parents[2]
    before = set(sys.modules)
    try:
        other = load_other(root)
        other_coupling = importlib.import_module(f"{other.__name__}.ops.coupling")
        other_bijectors = importlib.import_module(f"{other.__name__}.flows.bijectors")
        assert other_coupling is not coupling
        assert other_bijectors.affine_coupling_layer is other_coupling.affine_coupling_layer
        x, raw_s, t = _t(*_inputs(7, 2))
        for a, b in zip(other_coupling.affine_coupling(x, raw_s, t), coupling.affine_coupling(x, raw_s, t)):
            assert torch.equal(a, b)
    finally:
        for name in set(sys.modules) - before:
            if name.startswith("_other_nessai_tpu_torch"):
                del sys.modules[name]


def test_float64_distances_scale_by_the_larger_of_y_and_one():
    """``chip_smoke.float64_distances``: the largest absolute distance
    from y64 and the mean of |y - y64| / max(|y64|, 1), for the kernel's
    y and the plain version's, as ``chip_smoke.py``'s float64 gates read
    them."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py"
    )
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    float64_distances = chip_smoke.float64_distances

    y64 = torch.tensor([[0.5, -4.0], [100.0, 0.0]], dtype=torch.float64)
    y = (y64 + torch.tensor([[1e-3, 4e-3], [1e-1, 0.0]], dtype=torch.float64)).float()
    d = float64_distances(y, y64.float(), y64)
    assert d["max_abs"] == pytest.approx(1e-1, rel=1e-4)
    assert d["mean_scaled"] == pytest.approx((1e-3 + 1e-3 + 1e-3 + 0.0) / 4, rel=1e-4)
    assert d["plain_max_abs"] == 0.0 and d["plain_mean_scaled"] == 0.0
