"""Affine coupling: the CUDA kernels, their plain PyTorch versions and
their autograd rules.

Replaces the Pallas TPU kernel ``nessai_tpu/ops/coupling_pallas.py``
(``affine_coupling_transform``, ``pl.pallas_call`` at line 56) together
with the column gather and scatter around it in
``nessai_tpu/flows/bijectors.py:207-218``, and the backward of its
training wrapper ``affine_coupling_pallas_vjp`` (``_ac_bwd``, line 112,
``jax.vjp`` of the jnp reference). The kernels are
``csrc/affine_coupling.cu``, built with nvcc for ``sm_90a`` and bound
with ctypes (see ``_build.py``): ``affine_coupling_launch`` (forward or
inverse) and ``affine_coupling_backward_launch`` (the gradient).

What bounds them on an H100: bytes. A forward call moves
4·n·(2·D + 2·n_tr + 1) bytes (x, raw_s and t read once; y and the row
log-determinant written once) at 3.35 TB/s, with a few dozen operations
per transformed element. At the flagship's shapes (D = 2, n of
10³..10⁴) that is nanoseconds against a launch of about 1.4 µs, so what
a coupling layer costs is its count of launches. The kernels therefore
do a whole layer in one launch each way: forward, the split of x, the
affine map of the transformed columns, the copy of the identity columns
and the row log-determinant; backward, ``g_x`` (the identity columns
pass ``g_y`` through) and ``g_out = [g_raw | g_t]``, recomputing the
scale instead of saving ``y``. Both read the conditioner output through
its row stride, with no copy.

:func:`affine_coupling_layer` is the layer and :func:`affine_coupling`
the bare transform (every column transformed, one launch of the same
kernel). For both, a CPU tensor takes the plain
version, a CUDA tensor launches the kernels or raises. There is no
fall-back from one to the other.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

__all__ = [
    "affine_coupling",
    "affine_coupling_plain",
    "affine_coupling_backward_plain",
    "affine_coupling_layer",
    "affine_coupling_layer_plain",
    "affine_coupling_layer_backward_plain",
    "AffineCouplingFunction",
    "AffineCouplingLayerFunction",
]


def affine_coupling_plain(x, raw_s, t, inverse: bool = False, clamp: float = 5.0):
    """Plain PyTorch version: ``(y, log_det)`` with
    ``s = clamp * tanh(raw_s / clamp)``, ``y = x * exp(s) + t`` (or
    ``(x - t) * exp(-s)`` for the inverse) and ``log_det = ±sum(s, -1)``."""
    s = clamp * torch.tanh(raw_s / clamp)
    if inverse:
        return (x - t) * torch.exp(-s), -torch.sum(s, dim=-1)
    return x * torch.exp(s) + t, torch.sum(s, dim=-1)


def affine_coupling_backward_plain(x, raw_s, t, y, g, g_ld, inverse: bool = False, clamp: float = 5.0):
    """Plain version of the gradient: ``(g_x, g_raw_s, g_t)`` for the
    cotangents ``g`` of ``y`` and ``g_ld`` of the log-determinant (None
    for none), in closed form. With ``th = tanh(raw_s / clamp)`` and
    ``s = clamp·th``:

    - forward:  dx = g·eˢ,  dt = g,       draw = (g·x·eˢ + g_ld)·(1 − th²)
    - inverse:  dx = g·e⁻ˢ, dt = −g·e⁻ˢ, draw = (−g·y − g_ld)·(1 − th²)

    ``y`` is the transform's output (read for the inverse only). The op
    order is the backward kernel's rounding on the card."""
    th = torch.tanh(raw_s / clamp)
    s = clamp * th
    if g is None:
        g = torch.zeros_like(x)
    if g_ld is None:
        g_ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    dtanh = 1.0 - th * th
    if inverse:
        e = torch.exp(-s)
        gx = g * e
        return gx, (-g * y - g_ld[:, None]) * dtanh, -gx
    e = torch.exp(s)
    return g * e, (g * x * e + g_ld[:, None]) * dtanh, g


def _halves(out, n_tr):
    """``(raw_s, t)``: the column halves of the conditioner output, as views."""
    return out[:, :n_tr], out[:, n_tr:]


def affine_coupling_layer_plain(x, out, transform_idx, inverse: bool = False, clamp: float = 5.0):
    """Plain version of the layer: the columns ``transform_idx`` of ``x``
    go through :func:`affine_coupling_plain` with ``(raw_s, t)`` the
    halves of ``out``; the other columns are copied. Returns
    ``(y [n, D], log_det [n])``."""
    tr = transform_idx.long()
    y_tr, ld = affine_coupling_plain(x[:, tr], *_halves(out, tr.numel()), inverse, clamp)
    y = x.clone()
    y[:, tr] = y_tr
    return y, ld


def affine_coupling_layer_backward_plain(
    x, out, transform_idx, g_y, g_ld, inverse: bool = False, clamp: float = 5.0
):
    """Plain version of the layer's gradient: ``(g_x [n, D], g_out [n, 2·n_tr])``
    for the cotangents ``g_y`` and ``g_ld`` (None for none)."""
    tr = transform_idx.long()
    raw_s, t = _halves(out, tr.numel())
    x_tr = x[:, tr]
    y_tr = affine_coupling_plain(x_tr, raw_s, t, True, clamp)[0] if inverse else None
    g_tr = None if g_y is None else g_y[:, tr]
    gx_tr, graw, gt = affine_coupling_backward_plain(x_tr, raw_s, t, y_tr, g_tr, g_ld, inverse, clamp)
    g_x = torch.zeros_like(x) if g_y is None else g_y.clone()
    g_x[:, tr] = gx_tr
    return g_x, torch.cat([graw, gt], dim=1)


def _check(name, a, x, dims=2):
    if a.dtype != torch.float32:
        raise TypeError(f"affine_coupling: {name} must be float32, got {a.dtype}")
    if a.dim() != dims:
        raise ValueError(f"affine_coupling: {name} must have {dims} dimensions, got {tuple(a.shape)}")
    if a.device != x.device:
        raise ValueError(f"affine_coupling: {name} is on {a.device}, x on {x.device}")
    if a.shape[0] != x.shape[0]:
        raise ValueError(f"affine_coupling: {name} has {a.shape[0]} rows, x has {x.shape[0]}")


def _check_inputs(x, raw_s, t) -> None:
    for name, a in (("x", x), ("raw_s", raw_s), ("t", t)):
        _check(name, a, x)
        if a.shape != x.shape:
            raise ValueError(
                f"affine_coupling: {name} has shape {tuple(a.shape)}, x has {tuple(x.shape)}"
            )


def _check_layer_inputs(x, out, transform_idx) -> None:
    _check("x", x, x)
    _check("out", out, x)
    if transform_idx.dtype != torch.int32 or transform_idx.dim() != 1:
        raise TypeError(
            "affine_coupling_layer: transform_idx must be a 1-D int32 tensor, got "
            f"{transform_idx.dtype} of shape {tuple(transform_idx.shape)}"
        )
    if transform_idx.device != x.device:
        raise ValueError(
            f"affine_coupling_layer: transform_idx is on {transform_idx.device}, x on {x.device}"
        )
    n_tr = transform_idx.numel()
    if not 0 < n_tr <= x.shape[1] or out.shape[1] != 2 * n_tr:
        raise ValueError(
            f"affine_coupling_layer: {n_tr} transformed columns of {x.shape[1]} need "
            f"out of width {2 * n_tr}, got {tuple(out.shape)}"
        )


def _unit_columns(a):
    """``a`` itself where its columns are adjacent (any row stride), else
    a contiguous copy: the kernels read rows through their stride."""
    return a if a.shape[1] <= 1 or a.stride(1) == 1 else a.contiguous()


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of ``csrc/affine_coupling.cu``, built at first use."""
    from ._build import load

    lib = load("affine_coupling")
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    fwd = lib.affine_coupling_launch
    # x, raw, t with row strides; y, ld, transform_idx; n, D, n_tr, clamp, inverse, stream
    fwd.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, ptr, ptr, i64, i32, i32, f32, i32, ptr]
    fwd.restype = ctypes.c_int
    bwd = lib.affine_coupling_backward_launch
    # x, raw, t; gy, gld with strides; gx, graw, gt; transform_idx; n, D, n_tr, clamp, inverse, stream
    bwd.argtypes = [
        ptr, i64, ptr, i64, ptr, i64,
        ptr, i64, ptr, i64,
        ptr, ptr, i64, ptr, i64,
        ptr, i64, i32, i32, f32, i32, ptr,
    ]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _ptr(a):
    return 0 if a is None else a.data_ptr()


def _forward(x, raw_s, t, transform_idx, inverse: bool, clamp: float):
    """Launch ``affine_coupling_launch`` on PyTorch's current stream:
    ``(y [n, D], ld [n])``. The inputs' columns must be adjacent (any row
    stride); ``transform_idx`` None transforms every column."""
    n, D = x.shape
    y = torch.empty(n, D, dtype=x.dtype, device=x.device)
    ld = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y, ld
    fwd, _ = _kernels()
    with torch.cuda.device(x.device):
        err = fwd(
            x.data_ptr(), x.stride(0),
            raw_s.data_ptr(), raw_s.stride(0),
            t.data_ptr(), t.stride(0),
            y.data_ptr(), ld.data_ptr(), _ptr(transform_idx),
            n, D, raw_s.shape[1], float(clamp), int(bool(inverse)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"affine_coupling kernel launch failed with cudaError {err}")
    affine_coupling.launches += 1
    return y, ld


def _backward(x, raw_s, t, transform_idx, g_y, g_ld, g_raw, g_t, inverse: bool, clamp: float, need_gx: bool):
    """Launch ``affine_coupling_backward_launch``, writing ``g_raw`` and
    ``g_t`` (``[n, n_tr]`` views, unit column stride); returns ``g_x``
    (None unless ``need_gx``)."""
    n, D = x.shape
    g_x = torch.empty(n, D, dtype=x.dtype, device=x.device) if need_gx else None
    if n == 0:
        return g_x
    if g_y is not None:
        g_y = _unit_columns(g_y)
    _, bwd = _kernels()
    with torch.cuda.device(x.device):
        err = bwd(
            x.data_ptr(), x.stride(0),
            raw_s.data_ptr(), raw_s.stride(0),
            t.data_ptr(), t.stride(0),
            _ptr(g_y), 0 if g_y is None else g_y.stride(0),
            _ptr(g_ld), 0 if g_ld is None else g_ld.stride(0),
            _ptr(g_x), g_raw.data_ptr(), g_raw.stride(0), g_t.data_ptr(), g_t.stride(0),
            _ptr(transform_idx), n, D, raw_s.shape[1], float(clamp), int(bool(inverse)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"affine_coupling backward kernel launch failed with cudaError {err}")
    affine_coupling.backward_launches += 1
    return g_x


def _launch(x, raw_s, t, inverse: bool, clamp: float):
    """The bare transform through the kernel: every column transformed."""
    return _forward(x, raw_s, t, None, inverse, clamp)


def _launch_layer(x, out, transform_idx, inverse: bool, clamp: float):
    """The layer through the kernel: ``(y, ld)``."""
    return _forward(x, *_halves(out, transform_idx.numel()), transform_idx, inverse, clamp)


def _launch_layer_backward(x, out, transform_idx, g_y, g_ld, inverse: bool, clamp: float, need_gx=True):
    """The layer's gradient through the kernel: ``(g_x, g_out)``."""
    n_tr = transform_idx.numel()
    g_out = torch.empty(x.shape[0], 2 * n_tr, dtype=x.dtype, device=x.device)
    g_x = _backward(
        x, *_halves(out, n_tr), transform_idx, g_y, g_ld, *_halves(g_out, n_tr),
        inverse, clamp, need_gx,
    )
    return g_x, g_out


def _on_card(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise RuntimeError(f"affine_coupling: no kernel for device {x.device}")


class AffineCouplingFunction(torch.autograd.Function):
    """The bare transform: forward and backward through the kernels (the
    plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, raw_s, t, inverse, clamp):
        ctx.set_materialize_grads(False)
        ctx.inverse = bool(inverse)
        ctx.clamp = float(clamp)
        ctx.save_for_backward(x, raw_s, t)
        if _on_card(x):
            return _launch(x, raw_s, t, inverse, clamp)
        return affine_coupling_plain(x, raw_s, t, inverse, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, g_ld):
        if g is None and g_ld is None:
            return None, None, None, None, None
        x, raw_s, t = ctx.saved_tensors
        if _on_card(x):
            g_raw, g_t = torch.empty_like(raw_s), torch.empty_like(t)
            g_x = _backward(
                x, raw_s, t, None, g, g_ld, g_raw, g_t, ctx.inverse, ctx.clamp,
                ctx.needs_input_grad[0],
            )
            return g_x, g_raw, g_t, None, None
        y = affine_coupling_plain(x, raw_s, t, True, ctx.clamp)[0] if ctx.inverse else None
        return (*affine_coupling_backward_plain(x, raw_s, t, y, g, g_ld, ctx.inverse, ctx.clamp), None, None)


class AffineCouplingLayerFunction(torch.autograd.Function):
    """The layer, differentiable in ``x`` and the conditioner output
    ``out``; the column map ``transform_idx`` is static. One kernel launch
    forward, one backward (the plain versions on the CPU). A cotangent
    that is None (an output unused) costs nothing."""

    @staticmethod
    def forward(ctx, x, out, transform_idx, inverse, clamp):
        ctx.set_materialize_grads(False)
        ctx.inverse = bool(inverse)
        ctx.clamp = float(clamp)
        ctx.save_for_backward(x, out, transform_idx)
        if _on_card(x):
            return _launch_layer(x, out, transform_idx, inverse, clamp)
        return affine_coupling_layer_plain(x, out, transform_idx, inverse, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_ld):
        if g_y is None and g_ld is None:
            return None, None, None, None, None
        x, out, transform_idx = ctx.saved_tensors
        if _on_card(x):
            g_x, g_out = _launch_layer_backward(
                x, out, transform_idx, g_y, g_ld, ctx.inverse, ctx.clamp, ctx.needs_input_grad[0]
            )
        else:
            g_x, g_out = affine_coupling_layer_backward_plain(
                x, out, transform_idx, g_y, g_ld, ctx.inverse, ctx.clamp
            )
        return g_x, g_out, None, None, None


def affine_coupling(x, raw_s, t, inverse: bool = False, clamp: float = 5.0):
    """Fused affine coupling ``(x, raw_s, t) -> (y, log_det)`` on ``[n, d]``
    float32 tensors, differentiable in all three inputs.

    CUDA tensors launch ``csrc/affine_coupling.cu`` (each forward launch
    adds one to ``affine_coupling.launches``, each backward launch one to
    ``affine_coupling.backward_launches``); CPU tensors use
    :func:`affine_coupling_plain` and :func:`affine_coupling_backward_plain`."""
    _check_inputs(x, raw_s, t)
    return AffineCouplingFunction.apply(
        x.contiguous(), raw_s.contiguous(), t.contiguous(), inverse, clamp
    )


def affine_coupling_layer(x, out, transform_idx, inverse: bool = False, clamp: float = 5.0):
    """An affine coupling layer ``(x [n, D], out [n, 2·n_tr]) -> (y [n, D],
    log_det [n])``: the columns ``transform_idx`` (increasing, int32, on
    ``x``'s device) of ``x`` are mapped with ``raw_s = out[:, :n_tr]`` and
    ``t = out[:, n_tr:]`` as in :func:`affine_coupling`, the others are
    copied. Differentiable in ``x`` and ``out``.

    CUDA tensors launch ``csrc/affine_coupling.cu`` once forward and once
    backward (counted in ``affine_coupling.launches`` and
    ``affine_coupling.backward_launches``) and read ``x`` and ``out``
    through their row strides; CPU tensors use
    :func:`affine_coupling_layer_plain` and
    :func:`affine_coupling_layer_backward_plain`."""
    _check_layer_inputs(x, out, transform_idx)
    return AffineCouplingLayerFunction.apply(
        _unit_columns(x), _unit_columns(out), transform_idx.contiguous(), inverse, clamp
    )


#: Forward and inverse kernel launches (bare and layer) since the count
#: was last set to 0.
affine_coupling.launches = 0
#: Backward kernel launches since the count was last set to 0.
affine_coupling.backward_launches = 0
