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
