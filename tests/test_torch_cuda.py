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


#: coupling masks (1 marks an identity column): the flagship's two, a
#: mask in no order, every column transformed, and alternating masks at
#: widths that take 16-byte loads
LAYER_MASKS = [(1, 0), (0, 1), (0, 1, 1), (1, 0, 0, 1, 0), (0, 0, 0, 0), (1, 0) * 4, (1, 0) * 16]


def _layer_inputs(cuda, n, mask, seed):
    import numpy as np

    gen = torch.Generator(device=cuda).manual_seed(seed)
    tidx = torch.as_tensor(np.flatnonzero(np.asarray(mask) <= 0), dtype=torch.int32, device=cuda)
    n_tr = tidx.numel()
    x = torch.randn(n, len(mask), device=cuda, generator=gen)
    out = torch.randn(n, 2 * n_tr, device=cuda, generator=gen)
    out[:, :n_tr] *= 2.0
    cot = (torch.randn(n, len(mask), device=cuda, generator=gen), torch.randn(n, device=cuda, generator=gen))
    return x, out, tidx, cot


def _unfused_layer(x, out, tidx, inverse):
    """The layer as gathers, the bare kernel and a scatter: the unfused
    path that the layer kernel replaces (forward only)."""
    from nessai_tpu_torch.ops import coupling

    tr = tidx.long()
    n_tr = tr.numel()
    y_tr, ld = coupling._launch(
        x[:, tr].contiguous(), out[:, :n_tr].contiguous(), out[:, n_tr:].contiguous(), inverse, 5.0
    )
    y = x.clone()
    y[:, tr] = y_tr
    return y, ld


def _layer_grads(f, x, out, cot):
    xg, og = x.clone().requires_grad_(True), out.clone().requires_grad_(True)
    y, ld = f(xg, og)
    return torch.autograd.grad((y, ld), (xg, og), cot)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mask", LAYER_MASKS)
@pytest.mark.parametrize("n", [0, 1, 31, 257])
def test_affine_coupling_layer_kernels_match_plain(cuda, n, mask, inverse):
    """Forward against the plain version (and bitwise against the unfused
    path), backward against autograd of the plain version; one launch of
    each kernel per call (none for n = 0)."""
    from nessai_tpu_torch.ops import coupling

    x, out, tidx, cot = _layer_inputs(cuda, n, mask, seed=n + len(mask))
    before = coupling.affine_coupling.launches, coupling.affine_coupling.backward_launches
    with torch.no_grad():
        y, ld = coupling.affine_coupling_layer(x, out, tidx, inverse)
        y_ref, ld_ref = coupling.affine_coupling_layer_plain(x, out, tidx, inverse)
        y_unf, ld_unf = _unfused_layer(x, out, tidx, inverse)
    torch.cuda.synchronize()
    assert y.shape == x.shape and ld.shape == (n,)
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=0)
    assert torch.equal(y, y_unf) and torch.equal(ld, ld_unf)
    launched = 1 if n else 0
    assert coupling.affine_coupling.launches == before[0] + 2 * launched
    g_k = _layer_grads(lambda a, b: coupling.affine_coupling_layer(a, b, tidx, inverse), x, out, cot)
    g_p = _layer_grads(lambda a, b: coupling.affine_coupling_layer_plain(a, b, tidx, inverse), x, out, cot)
    torch.cuda.synchronize()
    assert coupling.affine_coupling.backward_launches == before[1] + launched
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_affine_coupling_layer_kernels_strided_and_special_inputs(cuda, inverse):
    """x with a row stride (read as it is) and with a column stride
    (copied), conditioner outputs with NaN and +-inf, and cotangents with
    a zero row stride."""
    from nessai_tpu_torch.ops import coupling

    mask = (1, 0, 0, 1, 0)
    x, out, tidx, cot = _layer_inputs(cuda, 257, mask, seed=4)
    wide = torch.randn(257, 9, device=cuda)
    wide[:, 2:7] = x
    cols = torch.randn(257, 10, device=cuda)
    cols[:, ::2] = x
    out[::7, 0] = float("nan")
    out[1::7, 1] = float("inf")
    out[2::7, 2] = -float("inf")
    for xs in (wide[:, 2:7], cols[:, ::2]):
        with torch.no_grad():
            y, ld = coupling.affine_coupling_layer(xs, out, tidx, inverse)
            y_ref, ld_ref = coupling.affine_coupling_layer_plain(x, out, tidx, inverse)
        torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-5, equal_nan=True)
        torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=0, equal_nan=True)
    gy = torch.randn(1, 5, device=cuda).expand(257, 5)
    gl = torch.randn(1, device=cuda).expand(257)
    g_x, g_out = coupling._launch_layer_backward(wide[:, 2:7], out, tidx, gy, gl, inverse, 5.0)
    ref = coupling.affine_coupling_layer_backward_plain(x, out, tidx, gy, gl, inverse)
    for a, b in zip((g_x, g_out), ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mask", [(65536, (1, 0) * 16), (4099, (1, 0, 0, 1, 0)), (900, (0, 1))])
def test_affine_coupling_layer_kernels_are_bitwise_deterministic(cuda, n, mask):
    """No atomics and a fixed shuffle order: two launches on the same
    inputs give the same bits."""
    from nessai_tpu_torch.ops import coupling

    x, out, tidx, (gy, gl) = _layer_inputs(cuda, n, mask, seed=9)
    for inverse in (False, True):
        for run in (
            lambda: coupling._launch_layer(x, out, tidx, inverse, 5.0),
            lambda: coupling._launch_layer_backward(x, out, tidx, gy, gl, inverse, 5.0),
            lambda: coupling._launch_layer_backward(x, out, tidx, None, gl, inverse, 5.0, False),
        ):
            first, second = run(), run()
            for a, b in zip(first, second):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_affine_coupling_layer_none_cotangents(cuda):
    """A cotangent that is None costs no zeros and gives the plain
    version's gradient of the other output."""
    from nessai_tpu_torch.ops import coupling

    x, out, tidx, (gy, gl) = _layer_inputs(cuda, 300, (1, 0, 0, 1, 0), seed=2)
    for g_y, g_ld in ((gy, None), (None, gl)):
        got = coupling._launch_layer_backward(x, out, tidx, g_y, g_ld, False, 5.0)
        ref = coupling.affine_coupling_layer_backward_plain(x, out, tidx, g_y, g_ld)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_affine_coupling_flow_counts_one_launch_each_way(cuda):
    """A RealNVP coupling on the GPU: one forward and one backward launch
    per coupling per training step."""
    from nessai_tpu_torch.flows import bijectors
    from nessai_tpu_torch.ops import coupling

    layer = bijectors.AffineCoupling([1, 0], n_neurons=8).to(cuda)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(900, 2, device=cuda)
    coupling.affine_coupling.launches = coupling.affine_coupling.backward_launches = 0
    z, ld = layer(x)
    (z.square().sum() + ld.sum()).backward()
    with torch.no_grad():
        back, _ = layer.inverse(z)
    torch.cuda.synchronize()
    assert coupling.affine_coupling.launches == 2
    assert coupling.affine_coupling.backward_launches == 1
    torch.testing.assert_close(back, x, atol=1e-5, rtol=1e-5)


def _spline_inputs(cuda, n, d, K, seed):
    """x ~ U(-6, 6) (the tails are covered) and raw parameters ~ N(0, 1),
    the parameters as slices of one conditioner-shaped output."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = 12.0 * torch.rand(n, d, device=cuda, generator=gen) - 6.0
    out = torch.randn(n, d, 3 * K - 1, device=cuda, generator=gen)
    return x, out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]


def _f64(*tensors):
    return [t.double() for t in tensors]


def _unit_inputs(cuda, n, d, K, seed):
    """x ~ U(-0.1, 1.1) (the unit box and beyond) and raw parameters ~
    N(0, 1), K + 1 derivatives: tails=None's inputs as slices of one
    conditioner-shaped output."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = 1.2 * torch.rand(n, d, device=cuda, generator=gen) - 0.1
    out = torch.randn(n, d, 3 * K + 1, device=cuda, generator=gen)
    return x, out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]


@pytest.mark.cuda
@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("m", [1, 31, 257, 70000])
@pytest.mark.parametrize("K", [1, 7, 8, 15, 17, 24, 31, 32, 33, 40, 64, 100])
def test_rqs_kernel_any_bins_and_tails(cuda, K, m, tails):
    """Every lane-group width (2 to 32 lanes; K + 1 items for tails=None)
    and the chunked path above 32 items, with partial warps, and at
    70,000 elements the path that spreads a warp's bins over its lanes:
    forward, inverse and the backward of the forward against the plain
    version in float64 (atol 1e-6 + rtol 1e-6), the unit box's outputs
    inside it, and one launch a call counted by tails."""
    from nessai_tpu_torch.ops.rqs import rqs, rqs_plain

    inputs = (_spline_inputs if tails == "linear" else _unit_inputs)(cuda, m, 1, K, seed=10 * K + m)
    gen = torch.Generator(device=cuda).manual_seed(K)
    w_y, w_ld = (torch.randn(m, 1, device=cuda, generator=gen) for _ in range(2))
    rqs.launches = rqs.unit_launches = rqs.unit_inverse_launches = 0
    for inverse in (False, True):
        with torch.no_grad():
            out = rqs(*inputs, inverse, 5.0, tails)
            ref = rqs_plain(*_f64(*inputs), inverse, 5.0, tails)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.double(), b, atol=1e-6, rtol=1e-6)
        if tails is None:
            x, y = inputs[0], out[0]
            box = (x >= 0) & (x <= 1)
            assert bool(((y[box] >= 0) & (y[box] <= 1)).all())
    assert rqs.launches == 2
    assert (rqs.unit_launches, rqs.unit_inverse_launches) == ((2, 1) if tails is None else (0, 0))
    rqs.unit_backward_launches = 0

    def grads(f, dtype):
        args = [a.detach().to(dtype).requires_grad_(True) for a in inputs]
        y, ld = f(*args, False, 5.0, tails)
        return torch.autograd.grad((y, ld), args, (w_y.to(dtype), w_ld.to(dtype)))

    for g_k, g_p in zip(grads(rqs, torch.float32), grads(rqs_plain, torch.float64)):
        torch.testing.assert_close(g_k.double(), g_p, atol=1e-6, rtol=1e-6)
    assert rqs.unit_backward_launches == (1 if tails is None else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 40])
def test_rqs_unit_box_kernel_is_bitwise_deterministic(cuda, K):
    from nessai_tpu_torch.ops.rqs import _launch, _launch_backward

    x, w, h, dd = _unit_inputs(cuda, 4096, 2, K, seed=6)
    gy, gl = (torch.randn(4096, 2, device=cuda) for _ in range(2))
    for run in (
        lambda: _launch(x, w, h, dd, False, 5.0, None),
        lambda: _launch(x, w, h, dd, True, 5.0, None),
        lambda: _launch_backward(x, w, h, dd, gy, gl, 5.0, None),
    ):
        first, second = run(), run()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


#: the new flow constructions, held GPU vs CPU: flow config, dimensions
#: and whether the inputs are points of the unit hypercube
NEW_FLOW_CONFIGS = {
    "realnvp_lu": (dict(n_blocks=4, n_layers=2, n_neurons=16, linear_transform="lu"), 2, False),
    "realnvp_svd": (dict(n_blocks=4, n_neurons="auto", linear_transform="svd"), 2, False),
    "maf": (dict(ftype="maf", n_blocks=4, n_neurons="auto"), 3, False),
    "nsf_logit": (dict(ftype="nsf", n_blocks=4, n_neurons="auto", pre_transform="logit"), 2, True),
    "realnvp_lars": (dict(n_blocks=4, n_neurons="auto", distribution="lars"), 2, False),
    "realnvp_mvn": (dict(n_blocks=4, n_neurons="auto", distribution="mvn", distribution_kwargs=dict(var=2.0)), 2,
                    False),
    "nsf_unit_hypercube": (
        dict(ftype="nsf", n_blocks=4, n_neurons=32, distribution="uniform", linear_transform=None,
             batch_norm_between_layers=False, tail_bound=1.0, tails=None, num_bins=8),
        4,
        True,
    ),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW_FLOW_CONFIGS))
def test_new_flows_gpu_match_cpu(cuda, name):
    """Each new construction's log_prob, forward and inverse on the GPU
    against the same (perturbed) weights on the CPU, in float64 where the
    flow has no affine coupling (whose plain version is float32 only):
    within 1e-4 of 1 + |CPU value| (the float32 flow's error)."""
    import numpy as np

    from nessai_tpu_torch.flows import configure_model
    from nessai_tpu_torch.flows.bijectors import AffineCoupling

    config, dims, unit = NEW_FLOW_CONFIGS[name]
    cpu = configure_model(dict(config, n_inputs=dims, seed=3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    gpu = configure_model(dict(config, n_inputs=dims, seed=3)).to(cuda)
    gpu.load_state_dict({k: v.to(cuda) for k, v in cpu.state_dict().items()})
    dtype = torch.float32 if any(isinstance(m, AffineCoupling) for m in cpu.modules()) else torch.float64
    cpu.to(dtype)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.001, 0.999, (2048, dims)) if unit else rng.normal(0, 1, (2048, dims))
    x = torch.as_tensor(x, dtype=torch.float32)
    with torch.no_grad():
        for f in (lambda fl, a: (fl.log_prob(a),), lambda fl, a: fl(a), lambda fl, a: fl.inverse(a)):
            for a, b in zip(f(gpu, x.to(cuda)), f(cpu, x.to(dtype))):
                b = b.double()
                assert torch.isfinite(b).all()
                assert float(((a.cpu().double() - b).abs() / (1 + b.abs())).max()) <= 1e-4


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,K,tails", [(900, 1, 8, "linear"), (13, 3, 40, "linear"), (1000, 2, 8, None)])
def test_rqs_inverse_backward_kernel_matches_autograd_of_plain(cuda, n, d, K, tails):
    """The gradient through the inverse direction launches the inverse
    backward kernel once and matches autograd of the plain inverse in
    float64 (atol 1e-6 + rtol 1e-6)."""
    from nessai_tpu_torch.ops.rqs import rqs, rqs_plain

    gen = torch.Generator(device=cuda).manual_seed(3 * n + K)
    if tails == "linear":
        y = 12.0 * torch.rand(n, d, device=cuda, generator=gen) - 6.0
        out = torch.randn(n, d, 3 * K - 1, device=cuda, generator=gen)
    else:
        y = 1.2 * torch.rand(n, d, device=cuda, generator=gen) - 0.1
        out = torch.randn(n, d, 3 * K + 1, device=cuda, generator=gen)
    inputs = (y, out[..., :K], out[..., K : 2 * K], out[..., 2 * K :])
    w_x, w_ld = (torch.randn(n, d, device=cuda, generator=gen) for _ in range(2))
    grads = []
    before = rqs.inverse_backward_launches
    for f, dtype in ((rqs, torch.float32), (rqs_plain, torch.float64)):
        args = [a.detach().to(dtype).requires_grad_(True) for a in inputs]
        x, ld = f(*args, True, 5.0, tails)
        grads.append(torch.autograd.grad((x, ld), args, (w_x.to(dtype), w_ld.to(dtype))))
    torch.cuda.synchronize()
    assert rqs.inverse_backward_launches == before + 1
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
    with pytest.raises(ValueError, match="shape"):
        rqs(x, w, h, dd, tails=None)  # K - 1 derivatives for the unit box
    # the gradient through the inverse direction launches its kernel
    before = rqs.inverse_backward_launches
    w_grad = w.detach().requires_grad_(True)
    y, ld = rqs(x, w_grad, h, dd, inverse=True)
    (y.sum() + ld.sum()).backward()
    assert rqs.inverse_backward_launches == before + 1


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


# ----------------------------------------------------------------------
# The importance nested sampler on the card
# ----------------------------------------------------------------------
def _ins_levels(device, n_levels=3, seed=5):
    """An ImportanceFlowModel of the INS flagship's flow with
    ``n_levels`` levels of perturbed weights, on ``device``."""
    import numpy as np

    from nessai_tpu_torch.flowmodel import ImportanceFlowModel

    fm = ImportanceFlowModel(dict(n_inputs=2), output=None, rng=np.random.default_rng(seed), device=device)
    fm.initialise()
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n_levels):
        with torch.no_grad():
            for p in fm.flow.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(p.device))
        fm.add_level(fm.flow)
    return fm


@pytest.mark.cuda
def test_ins_log_prob_all_gpu_matches_cpu(cuda, tmp_path, monkeypatch):
    import numpy as np

    from nessai_tpu_torch.flows.convert import params_to_jax, levels_from_jax
    from nessai_tpu_torch.ops import coupling

    monkeypatch.chdir(tmp_path)
    gpu = _ins_levels(cuda)
    cpu = _ins_levels("cpu")
    levels_from_jax(cpu, [params_to_jax(level) for level in gpu.models])
    x = 2.0 * np.random.default_rng(1).standard_normal((4096, 2))
    coupling.affine_coupling.launches = 0
    ours = gpu.log_prob_all(x)
    assert coupling.affine_coupling.launches == 4 * 3
    np.testing.assert_allclose(ours, cpu.log_prob_all(x), atol=1e-5, rtol=1e-5)
    for i in range(3):
        np.testing.assert_array_equal(gpu.log_prob_ith(x, i), ours[:, i])


def _capped_ins(tmp_path, device):
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    fs = FlowSampler(
        IntegrationTestModel(2),
        output=str(tmp_path),
        importance_nested_sampler=True,
        nlive=200,
        min_samples=100,
        seed=42,
        max_iteration=2,
        training_config=dict(max_epochs=20, patience=10, batch_size=500),
        plot=False,
        checkpointing=False,
        device=device,
    )
    fs.run(plot=False, save=False)
    return fs


@pytest.mark.cuda
def test_ins_capped_run_launches_k1(cuda, tmp_path):
    import numpy as np

    from nessai_tpu_torch.ops import coupling

    coupling.affine_coupling.launches = coupling.affine_coupling.backward_launches = 0
    fs = _capped_ins(tmp_path, "cuda")
    assert fs.ns.iteration == 2 and fs.ns.proposal.flow.n_models == 2
    assert np.isfinite(fs.logZ)
    assert coupling.affine_coupling.launches > 0
    assert coupling.affine_coupling.backward_launches > 0


@pytest.mark.cuda
def test_ins_capped_run_never_takes_the_plain_k1(cuda, tmp_path, monkeypatch):
    import numpy as np

    from nessai_tpu_torch.ops import coupling

    def refuse(*args, **kwargs):
        raise AssertionError("the plain K1 ran on the card")

    for name in (
        "affine_coupling_plain",
        "affine_coupling_backward_plain",
        "affine_coupling_layer_plain",
        "affine_coupling_layer_backward_plain",
    ):
        monkeypatch.setattr(coupling, name, refuse)
    fs = _capped_ins(tmp_path, "cuda")
    assert np.isfinite(fs.logZ)


@pytest.mark.cuda
def test_weighted_training_step_gpu_matches_cpu(cuda, tmp_path):
    """One weighted training step of the INS flagship's flow on the card
    (K1 forward and backward) against the same weights and batch on the
    CPU: the loss, the gradients and the stepped weights."""
    import numpy as np

    from nessai_tpu_torch.flowmodel import FlowModel
    from nessai_tpu_torch.ops import coupling

    torch.set_float32_matmul_precision("highest")
    models = {}
    for device in (cuda, "cpu"):
        fm = FlowModel(dict(n_inputs=2), output=str(tmp_path), rng=np.random.default_rng(3), device=device)
        fm.initialise()
        models[str(device)] = fm
    gpu, cpu = models["cuda"], models["cpu"]
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in cpu.flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    gpu.flow.load_state_dict(cpu.flow.state_dict())
    gpu.reset_optimiser()
    cpu.reset_optimiser()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(0.0, 2.0, (900, 2)), dtype=torch.float32)
    w = torch.as_tensor(rng.exponential(1.0, 900), dtype=torch.float32)
    coupling.affine_coupling.launches = coupling.affine_coupling.backward_launches = 0
    loss_gpu = gpu._train_step(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert coupling.affine_coupling.launches == 4 and coupling.affine_coupling.backward_launches == 4
    loss_cpu = cpu._train_step(x, w)
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, atol=1e-5, rtol=1e-5)
    for a, b in zip(gpu.flow.parameters(), cpu.flow.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_ins_redraw_on_the_card_repeats_bit_for_bit(cuda, tmp_path):
    """A capped run with the final redraw, twice from one seed on the
    card: the same redrawn samples and final logZ, bit for bit."""
    import numpy as np

    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.testing import GaussianMixture

    runs = []
    for k in range(2):
        fs = FlowSampler(
            GaussianMixture(2),
            output=str(tmp_path / str(k)),
            importance_nested_sampler=True,
            nlive=300,
            min_samples=100,
            seed=11,
            max_iteration=2,
            training_config=dict(max_epochs=30, patience=10),
            plot=False,
            checkpointing=False,
            device=cuda,
        )
        fs.run(plot=False, save=False, redraw_samples=True, n_posterior_samples=300)
        runs.append(fs)
    a, b = (fs.ns for fs in runs)
    assert np.isfinite(a.final_log_evidence) and a.final_log_evidence == b.final_log_evidence
    assert a.final_log_evidence_error == b.final_log_evidence_error
    for field in a.final_samples_unit.dtype.names:
        np.testing.assert_array_equal(a.final_samples_unit[field], b.final_samples_unit[field])


def _reparameterisation_names():
    from nessai_tpu_torch.utils.testing import REPARAMETERISATION_CASES

    return list(REPARAMETERISATION_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _reparameterisation_names(), ids=str)
def test_reparameterisation_device_inverse_gpu_matches_cpu(cuda, name):
    """Every registered name's ``torch_inverse`` on CUDA columns against
    the same on CPU columns, after an update and a forward pass: x
    columns within 1e-5 and log-Jacobians within 1e-3 of 1 + |CPU value|
    (``chip_smoke.py``'s tolerances against the host's float64)."""
    import numpy as np

    from nessai_tpu_torch.reparameterisations import get_reparameterisation
    from nessai_tpu_torch.utils.testing import reparameterisation_case

    parameters, bounds, kwargs, data = reparameterisation_case(name, 4096, seed=12)
    cls, config = get_reparameterisation(name)
    config.update(kwargs)
    r = cls(parameters=parameters, prior_bounds=bounds, rng=np.random.default_rng(13), **config)
    fields = list(data) + [a for a in r.auxiliary_parameters if a not in data]
    x = np.full(4096, np.nan, dtype=[(f, "f8") for f in fields])
    for f, v in data.items():
        x[f] = v
    r.update(x)
    x_prime = np.zeros(4096, dtype=[(f, "f8") for f in r.prime_parameters])
    _, x_prime, _ = r.reparameterise(x.copy(), x_prime, np.zeros(4096))
    outs = []
    for device in (cuda, torch.device("cpu")):
        cols = {f: torch.as_tensor(x_prime[f], dtype=torch.float32, device=device) for f in r.prime_parameters}
        updates, log_j = r.torch_inverse(cols)
        log_j = torch.as_tensor(log_j, dtype=torch.float32).expand(len(x_prime))
        outs.append(({f: v.cpu().double() for f, v in updates.items()}, log_j.cpu().double()))
    (gpu, lj_gpu), (cpu, lj_cpu) = outs
    assert set(gpu) == set(cpu)
    for f in cpu:
        assert ((gpu[f] - cpu[f]).abs() / (1 + cpu[f].abs())).max() <= 1e-5, f
    assert ((lj_gpu - lj_cpu).abs() / (1 + lj_cpu.abs())).max() <= 1e-3


def _scan_inputs(n, k, seed, ties=True, pad=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    live = np.sort(rng.normal(size=n)).astype(np.float32)
    pool = rng.normal(loc=float(live[n // 5]), scale=2.0, size=k).astype(np.float32)
    if ties:
        pool[::5] = live[0]
        pool[1::7] = live[n // 2]
    if pad:
        pool[-pad:] = -np.inf
    return live, pool


#: (regime, nlive, K, pad): PR 11's cases (``_scan_inputs``, with ties and
#: -inf padding; 40,000 live points on the global path), then the
#: regimes of ``utils.testing.ns_scan_case`` and each side of every change
#: of the kernel's shape (``ops.ns_scan.block_shape``) and memory path
NS_SCAN_KERNEL_CASES = [
    ("ties_padded", 1000, 1024, 24),
    ("ties_padded", 2000, 4096, 0),
    ("ties_padded", 40000, 512, 7),
    ("terminal", 2000, 4096, 0),
    ("ascending", 1000, 1024, 0),
    ("nan_inf", 1000, 1024, 0),
    ("ties", 1000, 1024, 0),
] + [
    ("mixed", n, 256 if n <= 4097 else 128, 0)
    for n in (1, 256, 257, 512, 513, 1024, 1025, 4096, 4097, 28672, 28673, 32768, 32769, 57344, 57345)
]


@pytest.mark.cuda
@pytest.mark.parametrize("max_accepts", [2**31 - 1, 17, 1, 0])
@pytest.mark.parametrize("regime,n,k,pad", NS_SCAN_KERNEL_CASES)
def test_ns_scan_kernel_matches_plain(cuda, regime, n, k, pad, max_accepts):
    """The scan kernel against its plain version, all five outputs equal:
    with ties and -inf padding, a terminal pool, a pool that accepts every
    step, NaN and infinite candidates, runs of ties, no accept, one, 17
    and none capped, on both sides of every change of the block's shape
    and of where the live set is held (registers, shared memory, the ids
    in global scratch, all in global scratch)."""
    from nessai_tpu_torch.ops.ns_scan import ns_scan, ns_scan_plain
    from nessai_tpu_torch.utils.testing import ns_scan_case

    if regime == "ties_padded":
        live, pool = _scan_inputs(n, k, n + k, pad=pad)
    else:
        live, pool = ns_scan_case(regime, n, k, seed=n + k)
    live_t, pool_t = torch.from_numpy(live), torch.from_numpy(pool)
    before = ns_scan.launches
    out = ns_scan(live_t.to(cuda), pool_t.to(cuda), max_accepts)
    torch.cuda.synchronize()
    assert ns_scan.launches == before + 1
    for a, b in zip(out, ns_scan_plain(live_t, pool_t, max_accepts)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_ns_scan_kernel_rejects_bad_input(cuda):
    from nessai_tpu_torch.ops.ns_scan import ns_scan

    live = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        ns_scan(live.double(), live.double(), 3)
    with pytest.raises(ValueError):
        ns_scan(live, live.cpu(), 3)


@pytest.mark.cuda
def test_device_stepping_on_the_card_matches_the_host_pass(cuda, tmp_path):
    """A capped run of the standard sampler on the card steps through its
    pools with the scan kernel, with the bits of the host batched pass."""
    import numpy as np

    from nessai_tpu_torch.ops.ns_scan import ns_scan
    from nessai_tpu_torch.samplers.nestedsampler import NestedSampler
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    runs = []
    for device_bookkeeping in (True, False):
        model = IntegrationTestModel(2)
        model.set_rng(np.random.default_rng(3))
        before = ns_scan.launches
        ns = NestedSampler(model, nlive=200, output=str(tmp_path / str(device_bookkeeping)), seed=4, plot=False,
                           checkpointing=False, maximum_uninformed=100, max_iteration=1500, poolsize=200,
                           flow_config=dict(n_blocks=2, n_neurons=8, n_layers=1),
                           training_config=dict(max_epochs=20, patience=5), device=cuda,
                           device_bookkeeping=device_bookkeeping)
        ns.nested_sampling_loop()
        runs.append((ns, ns_scan.launches - before))
    (dev, launches), (host, _) = runs
    assert launches > 0 and getattr(dev, "_n_device_steps", 0) > 0
    assert dev.iteration == host.iteration and dev.state.logZ == host.state.logZ
    assert dev.insertion_indices == host.insertion_indices


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["affine", "rqs"])
@pytest.mark.parametrize("mask", [(1, 0), (0, 1, 1)])
def test_conditioned_coupling_gpu_matches_cpu(cuda, kind, mask):
    """A coupling whose net takes ``[x_id, context]`` (a one-hot of 8
    labels): one K1 or K2 launch each way and one backward launch, and
    its outputs and gradients on the GPU against the same weights on the
    CPU (float32 for K1's plain version, float64 for the spline's)."""
    import copy

    from nessai_tpu_torch.flows import bijectors
    from nessai_tpu_torch.ops import coupling, rqs

    cls = bijectors.AffineCoupling if kind == "affine" else bijectors.RQSCoupling
    cpu = cls(list(mask), n_neurons=8, context_features=8)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn_like(p))
    gpu = copy.deepcopy(cpu).to(cuda)
    dtype = torch.float32 if kind == "affine" else torch.float64
    cpu.to(dtype)
    x = torch.randn(900, len(mask))
    context = torch.eye(8)[torch.randint(0, 8, (900,))]
    counter = coupling.affine_coupling if kind == "affine" else rqs
    counter.launches = counter.backward_launches = 0
    z, ld = gpu(x.to(cuda), context.to(cuda))
    (z.square().sum() + ld.sum()).backward()
    with torch.no_grad():
        back, _ = gpu.inverse(z, context.to(cuda))
    z_ref, ld_ref = cpu(x.to(dtype), context.to(dtype))
    (z_ref.square().sum() + ld_ref.sum()).backward()
    torch.cuda.synchronize()
    assert counter.launches == 2 and counter.backward_launches == 1
    torch.testing.assert_close(z.cpu().to(dtype), z_ref.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ld.cpu().to(dtype), ld_ref.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(back.cpu(), x, atol=1e-5, rtol=1e-5)
    for p_gpu, p_cpu in zip(gpu.parameters(), cpu.parameters()):
        torch.testing.assert_close(p_gpu.grad.cpu().to(dtype), p_cpu.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_clustering_flow_model_on_the_gpu(cuda, tmp_path):
    """k-means on the GPU gives the CPU's labels on separated blobs from
    the same generator, and the marginal log-density over the labels (one
    batched flow call) matches the CPU's."""
    import numpy as np

    from nessai_tpu_torch.experimental.flowmodel import ClusteringFlowModel, kmeans

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 2)) + np.array([[5.0, 5.0], [-5.0, -5.0], [5.0, -5.0]])[np.arange(3000) % 3]
    _, labels_gpu = kmeans(x, 3, rng=np.random.default_rng(1), device=cuda)
    _, labels_cpu = kmeans(x, 3, rng=np.random.default_rng(1), device="cpu")
    assert np.array_equal(labels_gpu, labels_cpu)
    models = []
    for device in (cuda, "cpu"):
        fm = ClusteringFlowModel(dict(n_inputs=2, n_blocks=4, n_neurons=8), output=str(tmp_path),
                                 rng=np.random.default_rng(2), device=device)
        fm.initialise()
        models.append(fm)
    state = {k: v + 0.05 * torch.randn(v.shape) if v.is_floating_point() else v
             for k, v in models[1].flow.state_dict().items()}
    for fm in models:
        fm.flow.load_state_dict(state)
        fm.train_clustering(x)
    assert models[0].n_clusters == models[1].n_clusters == 3
    z = rng.normal(size=(4096, 2))
    np.testing.assert_allclose(models[0].log_prob_marginalised(z), models[1].log_prob_marginalised(z),
                               atol=1e-4, rtol=1e-5)
