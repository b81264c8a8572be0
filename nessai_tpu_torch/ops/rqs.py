"""Rational-quadratic spline, with linear tails or on the unit box: the
CUDA kernels, the wrapper and its autograd rule.

Replaces the Pallas TPU kernel ``nessai_tpu/ops/rqs_pallas.py``
(``rqs_pallas``, ``pl.pallas_call`` at line 180, and its training
wrapper ``rqs_pallas_vjp``). The kernels are ``csrc/rqs.cu``, built with
nvcc for ``sm_90a`` and bound with ctypes (see ``_build.py``):
``rqs_forward_launch`` (the forward or inverse transform),
``rqs_backward_launch`` (the gradient of the forward transform) and
``rqs_inverse_backward_launch`` (that of the inverse), the gradients the
JAX package takes by autodiff of its jnp reference in either direction
(``rqs_pallas_vjp``, ``_rqs_bwd`` at line 228). All take
``tails``: linear tails on ``[-B, B]`` (the Pallas kernel's spline), or
``tails=None``, the spline of ``nessai_tpu/flows/rqs.py:28-158`` on the
unit box with all ``K + 1`` knot derivatives learned, which the JAX
package computes outside Pallas; and any number of bins.

What bounds them on an H100: by bytes, the forward moves 4·m·3K bytes
in and 8·m out for m elements and K bins, the backward 4·m·(3K + 2) in
and 4·m·3K out: tens of nanoseconds at the flagship's shapes (m ~ 10³),
where the launch and one element's dependent chain of double-precision
math set the time instead. The kernels therefore give each element a
group of G lanes (G the next power of two at or above K, or K + 1 with
``tails=None``, at most 32): lane k reads and normalises bin k, the
softmax sums and the knots are shuffles within the group, the bin is a
ballot, and lane k writes bin k's gradients; above 32 lane items a warp
takes one element in chunks of 32 bins (``csrc/rqs.cu``). The launch
(G, the grid) is chosen in C from K, the tails and the card's SM count;
the C signatures are those of the first port with a ``tails`` flag
(0 linear, 1 the unit box) before the stream.

:func:`rqs` is the wrapper: a CPU tensor takes the plain version
(``flows/rqs.py``) with autograd through it, a CUDA tensor launches the
kernels or raises. There is no fall-back from one to the other.

Layout: the parameters are read through their strides. The coupling's
conditioner output ``[n, n_tr, 3K - 1]`` is sliced into widths, heights
and derivatives, and each slice flattens to ``[m, K]`` rows with a row
stride of ``3K - 1`` (``3K + 1`` with ``tails=None``) and unit column
stride: the kernels read those views as they are, with no copy. A
parameter whose columns are not contiguous is copied once.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..flows.rqs import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    derivative_shift,
    n_derivatives,
    rational_quadratic_spline,
)

__all__ = ["rqs", "rqs_plain", "RQSFunction", "on_card"]

#: The kernels' ``tails`` flag.
_TAILS_FLAG = {"linear": 0, None: 1}


def rqs_plain(x, w, h, d, inverse: bool = False, tail_bound: float = 5.0, tails="linear"):
    """The plain PyTorch version: :func:`rational_quadratic_spline`,
    returning ``(y, per-element log-derivative)``."""
    return rational_quadratic_spline(x, w, h, d, inverse=inverse, tail_bound=tail_bound, tails=tails)


def on_card(x) -> bool:
    """Whether ``x`` goes to the kernels: True for a CUDA tensor, False
    for a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"rqs: no kernel for device {x.device}")


def _check_inputs(x, w, h, d, tails) -> None:
    K = w.shape[-1] if w.dim() else 0
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rqs: x must be float32 (or float64 on the CPU), got {x.dtype}")
    for name, a, last in (("x", x, None), ("w", w, K), ("h", h, K), ("d", d, n_derivatives(K, tails))):
        if a.dtype != x.dtype:
            raise TypeError(f"rqs: {name} is {a.dtype}, x is {x.dtype}")
        if a.device != x.device:
            raise ValueError(f"rqs: {name} is on {a.device}, x on {x.device}")
        want = tuple(x.shape) + (() if last is None else (last,))
        if tuple(a.shape) != want:
            raise ValueError(
                f"rqs: {name} has shape {tuple(a.shape)}, expected {want} "
                f"(x {tuple(x.shape)}, K = {K} bins)"
            )
    if K < 1:
        raise ValueError("rqs: needs at least one bin")


def _rows(a, m: int, k: int):
    """``a`` as ``[m, k]`` rows with unit column stride: a view where the
    strides allow it, else one contiguous copy."""
    a = a.reshape(m, k)
    if k > 1 and a.stride(1) != 1:
        a = a.contiguous()
    return a


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of ``csrc/rqs.cu``, built at first use."""
    from ._build import load

    lib = load("rqs")
    ptr, i64, i32, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
    params = [i64, i32, f64, f64, f64, f64, f64]  # m, K, B, min_w, min_h, min_d, shift
    fwd = lib.rqs_forward_launch
    # ..., inverse, tails, stream
    fwd.argtypes = [ptr, ptr, i64, ptr, i64, ptr, i64, ptr, ptr, *params, i32, i32, ptr]
    fwd.restype = ctypes.c_int
    backward = []
    for bwd in (lib.rqs_backward_launch, lib.rqs_inverse_backward_launch):
        # ..., tails, stream
        bwd.argtypes = [ptr, ptr, i64, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, *params, i32, ptr]
        bwd.restype = ctypes.c_int
        backward.append(bwd)
    return (fwd, *backward)


def _spline_args(m, K, tail_bound):
    return (
        m,
        K,
        float(tail_bound),
        DEFAULT_MIN_BIN_WIDTH,
        DEFAULT_MIN_BIN_HEIGHT,
        DEFAULT_MIN_DERIVATIVE,
        derivative_shift(DEFAULT_MIN_DERIVATIVE),
    )


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x, w, h, d, inverse: bool, tail_bound: float, tails="linear"):
    """Launch ``rqs_forward_launch`` on PyTorch's current stream; returns
    ``(y, ld)`` shaped as ``x``."""
    K = w.shape[-1]
    m = x.numel()
    xf = x.reshape(m).contiguous()
    w2, h2, d2 = _rows(w, m, K), _rows(h, m, K), _rows(d, m, n_derivatives(K, tails))
    y = torch.empty_like(xf)
    ld = torch.empty_like(xf)
    if m:
        fwd = _kernels()[0]
        with torch.cuda.device(x.device):
            err = fwd(
                xf.data_ptr(),
                w2.data_ptr(), w2.stride(0),
                h2.data_ptr(), h2.stride(0),
                d2.data_ptr(), d2.stride(0),
                y.data_ptr(), ld.data_ptr(),
                *_spline_args(m, K, tail_bound),
                int(bool(inverse)),
                _TAILS_FLAG[tails],
                _stream(x),
            )
        if err != 0:
            raise RuntimeError(f"rqs forward kernel launch failed with cudaError {err}")
        rqs.launches += 1
        if tails is None:
            rqs.unit_launches += 1
            rqs.unit_inverse_launches += int(bool(inverse))
    return y.reshape(x.shape), ld.reshape(x.shape)


def _launch_backward(x, w, h, d, gy, gl, tail_bound: float, tails="linear", inverse: bool = False):
    """Launch ``rqs_backward_launch`` (``rqs_inverse_backward_launch``
    with ``inverse``): the gradients of the forward (inverse) transform
    at ``x`` for the cotangents ``gy`` (of its output) and ``gl`` (of
    its log-derivative). Returns ``(dx, dw, dh, dd)`` shaped as the
    inputs."""
    K = w.shape[-1]
    n_d = n_derivatives(K, tails)
    m = x.numel()
    xf = x.reshape(m).contiguous()
    w2, h2, d2 = _rows(w, m, K), _rows(h, m, K), _rows(d, m, n_d)
    gy = gy.reshape(m).contiguous()
    gl = gl.reshape(m).contiguous()
    dx = torch.empty_like(xf)
    dw = torch.empty(m, K, dtype=x.dtype, device=x.device)
    dh = torch.empty_like(dw)
    dd = torch.empty(m, n_d, dtype=x.dtype, device=x.device)
    if m:
        bwd = _kernels()[2 if inverse else 1]
        with torch.cuda.device(x.device):
            err = bwd(
                xf.data_ptr(),
                w2.data_ptr(), w2.stride(0),
                h2.data_ptr(), h2.stride(0),
                d2.data_ptr(), d2.stride(0),
                gy.data_ptr(), gl.data_ptr(),
                dx.data_ptr(), dw.data_ptr(), dh.data_ptr(), dd.data_ptr(),
                *_spline_args(m, K, tail_bound),
                _TAILS_FLAG[tails],
                _stream(x),
            )
        if err != 0:
            raise RuntimeError(f"rqs backward kernel launch failed with cudaError {err}")
        if inverse:
            rqs.inverse_backward_launches += 1
            rqs.unit_inverse_backward_launches += int(tails is None)
        else:
            rqs.backward_launches += 1
            rqs.unit_backward_launches += int(tails is None)
    return dx.reshape(x.shape), dw.reshape(w.shape), dh.reshape(h.shape), dd.reshape(d.shape)


class RQSFunction(torch.autograd.Function):
    """Forward through ``rqs_forward_launch``; backward through
    ``rqs_backward_launch``, or ``rqs_inverse_backward_launch`` for the
    inverse direction."""

    @staticmethod
    def forward(ctx, x, w, h, d, inverse, tail_bound, tails):
        y, ld = _launch(x, w, h, d, inverse, tail_bound, tails)
        ctx.inverse = bool(inverse)
        ctx.tail_bound = float(tail_bound)
        ctx.tails = tails
        ctx.save_for_backward(x, w, h, d)
        return y, ld

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gl):
        # an output without a gradient arrives as zeros (autograd
        # materialises them by default)
        x, w, h, d = ctx.saved_tensors
        dx, dw, dh, dd = _launch_backward(x, w, h, d, gy, gl, ctx.tail_bound, ctx.tails, ctx.inverse)
        return dx, dw, dh, dd, None, None, None


def rqs(x, w, h, d, inverse: bool = False, tail_bound: float = 5.0, tails="linear"):
    """Rational-quadratic spline, elementwise over ``x`` (``[...]``), with
    unnormalised widths and heights ``[..., K]`` and derivatives ``[...,
    K - 1]`` (linear tails on ``[-tail_bound, tail_bound]``) or ``[...,
    K + 1]`` (``tails=None``: the unit box, where ``tail_bound`` is
    unused), all of one dtype. Returns ``(y, log-derivative)``, both
    shaped as ``x``; differentiable in all four inputs in either
    direction.

    CUDA tensors launch ``csrc/rqs.cu`` (each forward or inverse launch
    adds one to ``rqs.launches``, each backward launch of the forward one
    to ``rqs.backward_launches``, of the inverse one to
    ``rqs.inverse_backward_launches``; with ``tails=None`` also one to
    ``rqs.unit_launches`` (and, inverse, ``rqs.unit_inverse_launches``),
    ``rqs.unit_backward_launches`` or
    ``rqs.unit_inverse_backward_launches``); they must be float32. CPU
    tensors (float32 or float64) use the plain version, with autograd
    through it."""
    _check_inputs(x, w, h, d, tails)
    if not on_card(x):
        return rqs_plain(x, w, h, d, inverse, tail_bound, tails)
    if x.dtype != torch.float32:
        raise TypeError(f"rqs: the CUDA kernel takes float32, got {x.dtype}")
    return RQSFunction.apply(x, w, h, d, inverse, tail_bound, tails)


#: Forward and inverse kernel launches since the count was last set to 0.
rqs.launches = 0
#: Backward kernel launches of the forward direction since the count was
#: last set to 0,
rqs.backward_launches = 0
#: and of the inverse direction.
rqs.inverse_backward_launches = 0
#: Of those, the forward and inverse launches with ``tails=None``,
rqs.unit_launches = 0
#: the inverse ones among them,
rqs.unit_inverse_launches = 0
#: the backward launches of the forward direction with ``tails=None``,
rqs.unit_backward_launches = 0
#: and those of the inverse direction.
rqs.unit_inverse_backward_launches = 0
