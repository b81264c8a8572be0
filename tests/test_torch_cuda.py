"""On-card checks of the port's kernels against their plain versions.

Marked ``cuda``: they skip without a GPU. On a machine with an H100 and
the CUDA toolkit, run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: the shared conftest needs JAX, which that machine
need not have).
"""

import pytest
import torch


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,d", [(0, 1), (13, 3), (1000, 1), (4096, 8)])
def test_affine_coupling_kernel_matches_plain(cuda, n, d, inverse):
    from nessai_tpu_torch.ops import coupling

    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x, t = (torch.randn(n, d, device=cuda, generator=gen) for _ in range(2))
    raw_s = 2.0 * torch.randn(n, d, device=cuda, generator=gen)
    before = coupling.affine_coupling.launches
    y, ld = coupling.affine_coupling(x, raw_s, t, inverse)
    y_ref, ld_ref = coupling.affine_coupling_plain(x, raw_s, t, inverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=0)
    assert coupling.affine_coupling.launches == before + (1 if n else 0)


@pytest.mark.cuda
def test_affine_coupling_kernel_rejects_bad_input(cuda):
    from nessai_tpu_torch.ops import coupling

    x = torch.zeros(8, 2, device=cuda)
    with pytest.raises(TypeError):
        coupling.affine_coupling(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        coupling.affine_coupling(x, x.cpu(), x)


def _spline_inputs(cuda, n, d, K, seed):
    """x ~ U(-6, 6) (the tails are covered) and raw parameters ~ N(0, 1),
    the parameters as slices of one conditioner-shaped output."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = 12.0 * torch.rand(n, d, device=cuda, generator=gen) - 6.0
    out = torch.randn(n, d, 3 * K - 1, device=cuda, generator=gen)
    return x, out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]


def _f64(*tensors):
    return [t.double() for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,d,K", [(0, 1, 8), (13, 3, 8), (900, 1, 8), (4096, 4, 4), (257, 2, 16)])
def test_rqs_kernel_matches_plain(cuda, n, d, K, inverse):
    """The kernel computes in double between float32 loads and stores, so
    it is the float32 rounding of the plain version run in float64 on the
    same inputs (atol 1e-6 + rtol 1e-6, some 16 ulp)."""
    from nessai_tpu_torch.ops.rqs import rqs, rqs_plain

    x, w, h, dd = _spline_inputs(cuda, n, d, K, seed=n + d + K)
    before = rqs.launches
    with torch.no_grad():
        y, ld = rqs(x, w, h, dd, inverse)
        y_ref, ld_ref = rqs_plain(*_f64(x, w, h, dd), inverse)
    torch.cuda.synchronize()
    assert y.dtype == ld.dtype == torch.float32 and y.shape == ld.shape == x.shape
    torch.testing.assert_close(y.double(), y_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ld.double(), ld_ref, atol=1e-6, rtol=1e-6)
    assert rqs.launches == before + (1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,K", [(900, 1, 8), (13, 3, 8), (2048, 2, 4)])
def test_rqs_backward_kernel_matches_autograd_of_plain(cuda, n, d, K):
    from nessai_tpu_torch.ops.rqs import rqs, rqs_plain

    inputs = _spline_inputs(cuda, n, d, K, seed=7 * n + K)
    gen = torch.Generator(device=cuda).manual_seed(n)
    w_y, w_ld = (torch.randn(n, d, device=cuda, generator=gen) for _ in range(2))
    grads = []
    before = rqs.backward_launches
    for f, dtype in ((rqs, torch.float32), (rqs_plain, torch.float64)):
        args = [a.detach().to(dtype).requires_grad_(True) for a in inputs]
        y, ld = f(*args)
        ((y * w_y.to(dtype)).sum() + (ld * w_ld.to(dtype)).sum()).backward()
        grads.append([a.grad for a in args])
    torch.cuda.synchronize()
    assert rqs.backward_launches == before + 1
    for g_k, g_p in zip(*grads):
        assert g_k.dtype == torch.float32
        torch.testing.assert_close(g_k.double(), g_p, atol=1e-6, rtol=1e-6)


def _spline_grads(f, dtype, inputs, w_y, w_ld):
    args = [a.detach().to(dtype).requires_grad_(True) for a in inputs]
    y, ld = f(*args)
    return torch.autograd.grad((y, ld), args, (w_y.to(dtype), w_ld.to(dtype)))


def _assert_matches_f64_plain(inputs, w_y, w_ld, equal_nan=False):
    """Forward, inverse and the backward of the forward against the plain
    version in float64 (atol 1e-6 + rtol 1e-6)."""
    from nessai_tpu_torch.ops.rqs import rqs, rqs_plain

    for inverse in (False, True):
        with torch.no_grad():
            out = rqs(*inputs, inverse)
            ref = rqs_plain(*_f64(*inputs), inverse)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.double(), b, atol=1e-6, rtol=1e-6, equal_nan=equal_nan)
    grads = _spline_grads(rqs, torch.float32, inputs, w_y, w_ld)
    ref = _spline_grads(rqs_plain, torch.float64, inputs, w_y, w_ld)
    for g_k, g_p in zip(grads, ref):
        torch.testing.assert_close(g_k.double(), g_p, atol=1e-6, rtol=1e-6, equal_nan=equal_nan)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 31, 257])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 11, 16])
def test_rqs_kernel_every_lane_group(cuda, K, m):
    """Lane groups of 1 to 16 lanes (K not a power of two leaves lanes
    idle), with partial warps and groups at the end of the input."""
    inputs = _spline_inputs(cuda, m, 1, K, seed=100 * K + m)
    gen = torch.Generator(device=cuda).manual_seed(K)
    w_y, w_ld = (torch.randn(m, 1, device=cuda, generator=gen) for _ in range(2))
    _assert_matches_f64_plain(inputs, w_y, w_ld)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 11])
def test_rqs_kernel_knots_tails_and_nan(cuda, K):
    """x on the interior knots (rounded to float32), at +-B, just beyond
    the tails, far outside and NaN; then every element of each warp but
    one outside the tails. With the log-derivative's cotangent 0 the
    gradients are continuous across a knot, so a tie broken the other way
    (knots summed in another order) changes no gradient."""
    from nessai_tpu_torch.flows.rqs import DEFAULT_MIN_BIN_WIDTH, _knots, _normalise_bins

    n = 96
    _, w, h, dd = _spline_inputs(cuda, n, 1, K, seed=K)
    knots = _knots(_normalise_bins(w.double(), K, 10.0, DEFAULT_MIN_BIN_WIDTH), -5.0, 5.0)
    inner = knots[:, 0, 1:-1].float()
    special = torch.tensor([-5.0, 5.0, -5.0000005, 5.0000005, 9.0, -7.0, float("nan"), 0.0], device=cuda)
    x = special[torch.arange(n, device=cuda) % 8].reshape(n, 1)
    if K > 1:
        x[::2, 0] = inner[torch.arange(0, n, 2, device=cuda), torch.arange(n // 2, device=cuda) % (K - 1)]
    gen = torch.Generator(device=cuda).manual_seed(3)
    w_y = torch.randn(n, 1, device=cuda, generator=gen)
    zero = torch.zeros(n, 1, device=cuda)
    _assert_matches_f64_plain((x, w, h, dd), w_y, zero, equal_nan=True)
    # one element inside per warp (32 // G elements a warp)
    per_warp = 32 // (1 << (K - 1).bit_length())
    lone = torch.full((n, 1), 9.0, device=cuda)
    lone[:: per_warp] = 0.3
    _assert_matches_f64_plain((lone, w, h, dd), w_y, torch.randn(n, 1, device=cuda, generator=gen))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,K", [(4096, 4, 8), (2048, 3, 11)])
def test_rqs_kernel_is_bitwise_deterministic(cuda, n, d, K):
    """No atomics and a fixed shuffle order: two launches on the same
    inputs give the same bits."""
    from nessai_tpu_torch.ops.rqs import _launch, _launch_backward

    x, w, h, dd = _spline_inputs(cuda, n, d, K, seed=5)
    gy, gl = (torch.randn(n, d, device=cuda) for _ in range(2))
    for run in (
        lambda: _launch(x, w, h, dd, False, 5.0),
        lambda: _launch(x, w, h, dd, True, 5.0),
        lambda: _launch_backward(x, w, h, dd, gy, gl, 5.0),
    ):
        first, second = run(), run()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_rqs_kernel_round_trip_and_counters(cuda):
    from nessai_tpu_torch.ops.rqs import rqs

    x, w, h, dd = _spline_inputs(cuda, 1000, 1, 8, seed=3)
    rqs.launches = rqs.backward_launches = 0
    with torch.no_grad():
        z, ld = rqs(x, w, h, dd)
        x_back, ld_inv = rqs(z, w, h, dd, inverse=True)
    torch.cuda.synchronize()
    assert rqs.launches == 2 and rqs.backward_launches == 0
    # the float32 rounding of z, stretched by the inverse's slope
    slope = 1.0 + torch.exp(-ld)
    assert torch.all((x_back - x).abs() <= 1e-6 * slope)
    assert torch.all((ld + ld_inv).abs() <= 1e-3 * slope)


@pytest.mark.cuda
def test_rqs_kernel_rejects_bad_input(cuda):
    from nessai_tpu_torch.ops.rqs import rqs

    x, w, h, dd = _spline_inputs(cuda, 8, 2, 8, seed=1)
    with pytest.raises(TypeError):
        rqs(x.double(), w.double(), h.double(), dd.double())
    with pytest.raises(ValueError):
        rqs(x, w.cpu(), h, dd)
    with pytest.raises(ValueError, match="shape"):
        rqs(x, w, h, w)
    with pytest.raises(ValueError, match="at most 16"):
        big = torch.zeros(8, 2, 17, device=cuda)
        rqs(x, big, big, big[..., :16])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rqs(x, w.detach().requires_grad_(True), h, dd, inverse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("tracing", [True, False])
def test_device_time_ms_with_and_without_gpu_tracing(cuda, tracing, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from nessai_tpu_torch.utils import profiling

    if not tracing:
        # a profiler that records no GPU work, as where CUPTI is taken
        monkeypatch.setattr(profiling, "_profile", lambda: profile(activities=[ProfilerActivity.CPU]))
    x = torch.randn(1 << 20, device=cuda)
    ms, records, timer = profiling.device_time_ms(lambda: x.mul(2.0), calls=20)
    assert ms > 0.0
    if tracing:
        assert timer == "torch.profiler" and records >= 1.0
    else:
        assert timer == "cuda_events" and records is None
