"""The port's rational-quadratic spline against the JAX package's.

The plain version (``nessai_tpu_torch/flows/rqs.py``) is held against
the jnp reference (``nessai_tpu/flows/rqs.py``) in both directions and
both tail modes, and against the Pallas kernel in interpret mode; the
kernel wrapper (``nessai_tpu_torch/ops/rqs.py``) runs that plain version
on CPU tensors, so its gradients are held against ``jax.grad`` of
``rqs_pallas_vjp``. The CUDA kernels themselves are held against the
plain version on the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: outputs atol 2e-5 + rtol 1e-5 and log-derivatives atol
2e-4 + rtol 1e-4, gradients atol 1e-3 + rtol 1e-3. Both sides compute
in float32, where a knot rounds to an ulp of the tail bound (~5e-7) and
a narrow bin with a steep derivative ratio amplifies that: on these
inputs the two float32 versions each stray from a float64 evaluation
by up to 2e-5 in the output and 1.4e-4 in the log-derivative. The
Pallas kernel's own test holds it to the jnp body at 1e-4 and 1e-3
(``tests/test_ops.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.flows.rqs import rational_quadratic_spline as jax_spline
from nessai_tpu.ops.rqs_pallas import rqs_pallas, rqs_pallas_vjp
from nessai_tpu_torch.flows.rqs import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    rational_quadratic_spline,
)

# the module: ``nessai_tpu_torch.ops.rqs`` as an attribute is the wrapper
rqs_ops = importlib.import_module("nessai_tpu_torch.ops.rqs")

Y_ATOL, Y_RTOL = 2e-5, 1e-5
LD_ATOL, LD_RTOL = 2e-4, 1e-4
GRAD_ATOL = GRAD_RTOL = 1e-3


def _inputs(shape, K, tails="linear", seed=0):
    """The inputs of ``tests/test_ops.py``: x uniform over the spline's
    box and a margin beyond it (so the tails are covered), raw
    parameters standard normal."""
    rng = np.random.default_rng(seed)
    lo, hi = (-6.0, 6.0) if tails == "linear" else (-0.2, 1.2)
    n_deriv = K - 1 if tails == "linear" else K + 1
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    w = rng.normal(size=shape + (K,)).astype(np.float32)
    h = rng.normal(size=shape + (K,)).astype(np.float32)
    d = rng.normal(size=shape + (n_deriv,)).astype(np.float32)
    return x, w, h, d


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(ours, theirs):
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), atol=Y_ATOL, rtol=Y_RTOL)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]), atol=LD_ATOL, rtol=LD_RTOL)


def test_constants_match_jax():
    from nessai_tpu.flows import rqs as jax_rqs

    assert DEFAULT_MIN_BIN_WIDTH == jax_rqs.DEFAULT_MIN_BIN_WIDTH
    assert DEFAULT_MIN_BIN_HEIGHT == jax_rqs.DEFAULT_MIN_BIN_HEIGHT
    assert DEFAULT_MIN_DERIVATIVE == jax_rqs.DEFAULT_MIN_DERIVATIVE


@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((300, 3), 8), ((64,), 4), ((50, 2), 2)])
def test_plain_matches_jax_reference(shape, K, inverse, tails):
    x, w, h, d = _inputs(shape, K, tails, seed=K + len(shape))
    ref = jax_spline(x, w, h, d, inverse=inverse, tails=tails)
    ours = rational_quadratic_spline(*_t(x, w, h, d), inverse=inverse, tails=tails)
    _close(ours, ref)


@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((200, 2), 24), ((100,), 40), ((64,), 33)])
def test_plain_matches_jax_reference_at_many_bins(shape, K, inverse, tails):
    """More bins than the first kernels took, both tails, in float64 in
    both packages (to 1e-9): at 24 bins a bin is narrow enough that the
    two float32 versions part by 5e-4 in the log-derivative of one
    element in 400, each as far from the float64 spline."""
    x, w, h, d = _inputs(shape, K, tails, seed=K + len(shape))
    with jax.enable_x64(True):
        ref = jax_spline(*(a.astype(np.float64) for a in (x, w, h, d)), inverse=inverse, tails=tails)
        ref = [np.asarray(r) for r in ref]
    ours = rational_quadratic_spline(*(t.double() for t in _t(x, w, h, d)), inverse=inverse, tails=tails)
    for a, r in zip(ours, ref):
        assert r.dtype == np.float64
        np.testing.assert_allclose(a.numpy(), r, atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_pallas_interpret(inverse):
    x, w, h, d = _inputs((300, 3), 8, seed=11)
    ref = rqs_pallas(x, w, h, d, inverse=inverse, interpret=True)
    _close(rqs_ops.rqs(*_t(x, w, h, d), inverse=inverse), ref)


def test_identity_at_zero_parameters():
    x = torch.linspace(-7.0, 7.0, 57)
    zeros = torch.zeros(57, 8)
    for inverse in (False, True):
        y, ld = rational_quadratic_spline(x, zeros, zeros, zeros[:, :7], inverse=inverse)
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-6)
        np.testing.assert_allclose(ld.numpy(), 0.0, atol=2e-6)


@pytest.mark.parametrize("K", [4, 8])
def test_round_trip(K):
    x, w, h, d = _t(*_inputs((128, 2), K, seed=K))
    z, ld = rqs_ops.rqs(x, w, h, d)
    x_back, ld_inv = rqs_ops.rqs(z, w, h, d, inverse=True)
    # float32 bin-edge round-trip precision, as tests/test_ops.py
    np.testing.assert_allclose(x_back.numpy(), x.numpy(), atol=5e-4)
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=5e-3)


@pytest.mark.parametrize("n,d,K", [(8, 2, 4), (40, 3, 8)])
def test_gradients_match_jax(n, d, K):
    x, w, h, dd = _inputs((n, d), K, seed=n)
    x = (x / 2).astype(np.float32)  # mostly inside, as tests/test_ops.py
    rng = np.random.default_rng(5)
    w_y = rng.standard_normal((n, d)).astype(np.float32)
    w_ld = rng.standard_normal((n, d)).astype(np.float32)

    def loss_jax(a, b, c, e):
        y, ld = rqs_pallas_vjp(a, b, c, e, False, 5.0, True)
        return jnp.sum(y * w_y) + jnp.sum(ld * w_ld)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, w, h, dd)))
    args = [a.requires_grad_(True) for a in _t(x, w, h, dd)]
    y, ld = rqs_ops.rqs(*args)
    (torch.sum(y * torch.as_tensor(w_y)) + torch.sum(ld * torch.as_tensor(w_ld))).backward()
    for a, g in zip(args, g_jax):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("K", [8, 40])
def test_inverse_gradients_match_jax(K, tails):
    """The plain version's gradients through the inverse direction (the
    reference the inverse backward kernel is held to on the card) against
    the JAX package's: ``rqs_pallas_vjp(..., inverse=True,
    interpret=True)`` for linear tails (its backward is ``jax.vjp`` of
    the jnp spline in that direction, ``_rqs_bwd``), and ``jax.vjp`` of
    the jnp spline with ``tails=None``, which the JAX package runs outside
    Pallas. Inputs over the box and beyond it; GRAD_ATOL and GRAD_RTOL."""
    x, w, h, dd = _inputs((40, 3), K, tails, seed=K)
    rng = np.random.default_rng(K + 1)
    w_x = rng.standard_normal(x.shape).astype(np.float32)
    w_ld = rng.standard_normal(x.shape).astype(np.float32)

    def loss_jax(a, b, c, e):
        if tails == "linear":
            y, ld = rqs_pallas_vjp(a, b, c, e, True, 5.0, True)
        else:
            y, ld = jax_spline(a, b, c, e, inverse=True, tails=None)
        return jnp.sum(y * w_x) + jnp.sum(ld * w_ld)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, w, h, dd)))
    args = [a.requires_grad_(True) for a in _t(x, w, h, dd)]
    y, ld = rqs_ops.rqs(*args, inverse=True, tails=tails)
    (torch.sum(y * torch.as_tensor(w_x)) + torch.sum(ld * torch.as_tensor(w_ld))).backward()
    for a, g in zip(args, g_jax):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_outside_the_tails_passes_through_with_unit_gradient():
    x = torch.tensor([-9.0, -5.5, 5.5, 12.0], requires_grad=True)
    w, h = (torch.randn(4, 6, requires_grad=True) for _ in range(2))
    d = torch.randn(4, 5, requires_grad=True)
    y, ld = rqs_ops.rqs(x, w, h, d)
    (y.sum() + ld.sum()).backward()
    assert torch.equal(y, x) and torch.count_nonzero(ld) == 0
    assert torch.equal(x.grad, torch.ones(4))
    for p in (w, h, d):
        assert torch.count_nonzero(p.grad) == 0


def test_cpu_tensors_take_the_plain_version():
    rqs_ops.rqs.launches = rqs_ops.rqs.backward_launches = 0
    x, w, h, d = (a.requires_grad_(True) for a in _t(*_inputs((16, 2), 8, seed=3)))
    y, ld = rqs_ops.rqs(x, w, h, d)
    y_ref, ld_ref = rational_quadratic_spline(x, w, h, d)
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
    (y.sum() + ld.sum()).backward()
    assert rqs_ops.rqs.launches == 0 and rqs_ops.rqs.backward_launches == 0


def test_wrapper_rejects_bad_input():
    x, w, h, d = _t(*_inputs((5, 2), 8))
    with pytest.raises(TypeError, match="float64"):
        rqs_ops.rqs(x, w.double(), h, d)
    with pytest.raises(TypeError):
        rqs_ops.rqs(x.half(), w.half(), h.half(), d.half())
    with pytest.raises(ValueError, match="shape"):
        rqs_ops.rqs(x, w[..., :7], h, d)
    with pytest.raises(ValueError, match="shape"):
        rqs_ops.rqs(x, w, h, h)
    with pytest.raises(ValueError, match="shape"):
        rqs_ops.rqs(x[0], w, h, d)
    with pytest.raises(RuntimeError, match="no kernel"):
        rqs_ops.rqs(*(a.to("meta") for a in (x, w, h, d)))


def test_cpu_float64_takes_the_plain_version():
    """Float64 CPU tensors run the plain version in float64 (the
    reference the kernel's double arithmetic is held to)."""
    x, w, h, d = (a.double() for a in _t(*_inputs((16, 2), 8, seed=4)))
    y, ld = rqs_ops.rqs(x, w, h, d, inverse=True)
    y_ref, ld_ref = rational_quadratic_spline(x, w, h, d, inverse=True)
    assert y.dtype == torch.float64
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)


def test_wrapper_takes_strided_parameter_views():
    """The coupling's slices of one conditioner output give the same
    result as contiguous copies."""
    x = torch.as_tensor(_inputs((7, 3), 8)[0])
    out = torch.randn(7, 3, 23)
    w, h, d = out[..., :8], out[..., 8:16], out[..., 16:]
    assert not w.is_contiguous()
    y, ld = rqs_ops.rqs(x, w, h, d)
    y_c, ld_c = rqs_ops.rqs(x, w.contiguous(), h.contiguous(), d.contiguous())
    assert torch.equal(y, y_c) and torch.equal(ld, ld_c)
    m = x.numel()
    w_rows = rqs_ops._rows(w, m, 8)
    assert w_rows.data_ptr() == w.data_ptr() and w_rows.stride() == (23, 1)


@pytest.fixture()
def pretend_cuda(monkeypatch):
    """Route CPU tensors down the CUDA path of the wrapper, to check what
    it refuses before any launch (no GPU needed)."""
    monkeypatch.setattr(rqs_ops, "on_card", lambda x: True)

    def no_launch(*args, **kwargs):
        raise AssertionError("the kernel was launched")

    monkeypatch.setattr(rqs_ops, "_launch", no_launch)


def test_inverse_gradient_on_cuda_reaches_the_inverse_backward_launch(pretend_cuda, monkeypatch):
    """On the card the gradient through the inverse direction goes to the
    inverse-direction backward launch (a stand-in here that records its
    direction), float64 is refused, and more than 16 bins (the limit of
    the first kernels) go to the kernel."""
    calls = []

    def launch_backward(x, w, h, d, gy, gl, bound, tails, inverse):
        calls.append(inverse)
        return gy, torch.zeros_like(w), torch.zeros_like(h), torch.zeros_like(d)

    monkeypatch.setattr(rqs_ops, "_launch_backward", launch_backward)
    x, w, h, d = _t(*_inputs((6, 1), 8))
    w = w.requires_grad_(True)
    with monkeypatch.context() as m:
        m.setattr(rqs_ops, "_launch", lambda x, *args: (x.clone(), torch.zeros_like(x)))
        y, ld = rqs_ops.rqs(x, w, h, d, inverse=True)
    (y.sum() + ld.sum()).backward()
    assert calls == [True] and w.grad is not None
    with pytest.raises(AssertionError, match="the kernel was launched"):
        rqs_ops.rqs(*_t(*_inputs((6, 1), 17)))
    with pytest.raises(TypeError, match="CUDA kernel takes float32"):
        rqs_ops.rqs(x.double(), w.double(), h.double(), d.double())


@pytest.mark.parametrize("K", [1, 8, 17, 24, 32, 40, 100])
@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("inverse", [False, True])
def test_any_bins_and_tails_go_to_the_kernel_on_cuda(pretend_cuda, monkeypatch, tails, inverse, K):
    """On a CUDA tensor every bin count and both tails reach the kernel's
    launch, with the derivatives' K - 1 or K + 1 columns and the tails
    passed on (the launch is a stand-in that records its arguments)."""
    calls = []

    def launch(x, w, h, d, inv, bound, tails_):
        calls.append((d.shape[-1], inv, tails_))
        return x, torch.zeros_like(x)

    monkeypatch.setattr(rqs_ops, "_launch", launch)
    x, w, h, d = _t(*_inputs((6, 2), K, tails))
    rqs_ops.rqs(x, w, h, d, inverse, 5.0, tails)
    assert calls == [(K - 1 if tails == "linear" else K + 1, inverse, tails)]


@pytest.mark.parametrize("tails", ["linear", None])
def test_coupling_goes_to_the_kernel_on_cuda_with_its_tails(pretend_cuda, monkeypatch, tails):
    """``RQSCoupling`` sends both tails to the kernel wrapper on the card
    (``tails=None`` raised there before the kernel took it)."""
    from nessai_tpu_torch.flows.bijectors import RQSCoupling

    seen = []
    monkeypatch.setattr(rqs_ops, "_launch", lambda x, w, h, d, inv, bound, t: seen.append((t, d.shape[-1])) or
                        (x, torch.zeros_like(x)))
    coupling = RQSCoupling([1, 0], n_neurons=4, num_bins=8, tails=tails)
    with torch.no_grad():
        coupling(torch.rand(5, 2))
        coupling.inverse(torch.rand(5, 2))
    assert seen == [(tails, 7 if tails == "linear" else 9)] * 2


@pytest.mark.parametrize("K", [8, 24, 40])
def test_unit_box_plain_spline(K):
    """tails=None on the CPU: the plain version against the jnp spline at
    any bin count, gradients against ``jax.grad`` of it, the round trip,
    inputs outside [0, 1] passed through, and outputs inside the box."""
    x, w, h, d = _inputs((120, 2), K, None, seed=K)
    for inverse in (False, True):
        ref = jax_spline(x, w, h, d, inverse=inverse, tails=None)
        ours = rqs_ops.rqs(*_t(x, w, h, d), inverse=inverse, tails=None)
        _close(ours, ref)
        inside = (x >= 0) & (x <= 1)
        assert np.all((ours[0].numpy()[inside] >= 0) & (ours[0].numpy()[inside] <= 1))
        assert np.array_equal(ours[0].numpy()[~inside], x[~inside])
        assert np.all(ours[1].numpy()[~inside] == 0)
    rng = np.random.default_rng(K)
    w_y, w_ld = rng.standard_normal((2, 120, 2)).astype(np.float32)

    def loss_jax(a, b, c, e):
        y, ld = jax_spline(a, b, c, e, tails=None)
        return jnp.sum(y * w_y) + jnp.sum(ld * w_ld)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, w, h, d)))
    args = [a.requires_grad_(True) for a in _t(x, w, h, d)]
    y, ld = rqs_ops.rqs(*args, tails=None)
    (torch.sum(y * torch.as_tensor(w_y)) + torch.sum(ld * torch.as_tensor(w_ld))).backward()
    for a, g in zip(args, g_jax):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    xt, wt, ht, dt = _t(x, w, h, d)
    z, ld_f = rqs_ops.rqs(xt, wt, ht, dt, tails=None)
    x_back, ld_i = rqs_ops.rqs(z, wt, ht, dt, inverse=True, tails=None)
    np.testing.assert_allclose(x_back.numpy(), x, atol=5e-4)
    np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=5e-3)


def test_wrapper_checks_the_derivatives_of_its_tails():
    from nessai_tpu_torch.flows.bijectors import RQSCoupling

    x, w, h, d = _t(*_inputs((5, 2), 8, None))
    with pytest.raises(ValueError, match="shape"):
        rqs_ops.rqs(x, w, h, d)  # K + 1 derivatives with linear tails
    with pytest.raises(ValueError, match="Unknown tails"):
        rqs_ops.rqs(x, w, h, d, tails="quadratic")
    assert rqs_ops.n_derivatives(8) == 7 and rqs_ops.n_derivatives(8, None) == 9
    with pytest.raises(ValueError, match="Unknown tails"):
        RQSCoupling([1, 0], n_neurons=4, tails="quadratic")


def test_ptxas_report_parses_registers_and_spills():
    """The build keeps ptxas's report beside each library; ``chip_smoke.py``
    reads registers and spills of every kernel from it (and fails on a
    spill)."""
    from nessai_tpu_torch.ops._build import _kernel_name, parse_ptxas

    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118rqs_forward_kernelILi8EEEvPKfS2_lS2_lS2_lPfS3_lNS_12SplineParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118rqs_forward_kernelILi8EEEvPKfS2_lS2_lS2_lPfS3_lNS_12SplineParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a6b0d7fc_18_affine_coupling_cu_67f2401822affine_coupling_kernelEPKfS1_S1_PfS2_lifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a6b0d7fc_18_affine_coupling_cu_67f2401822affine_coupling_kernelEPKfS1_S1_PfS2_lifi
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 404 bytes cmem[0]
"""
    assert parse_ptxas(report) == [
        dict(kernel="rqs_forward_kernel<8>", registers=40, spill_store_bytes=0, spill_load_bytes=0),
        dict(kernel="affine_coupling_kernel", registers=255, spill_store_bytes=12, spill_load_bytes=16),
    ]
    assert parse_ptxas("") == []
    assert _kernel_name("_Z6kernelPf") == "kernel"
    assert _kernel_name("_ZN12_GLOBAL__N_118rqs_forward_kernelILi16ELb1EEEvPKf") == (
        "rqs_forward_kernel<16, 1>"
    )
