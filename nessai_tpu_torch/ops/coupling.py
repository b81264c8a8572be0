"""Fused affine-coupling transform: the CUDA kernel, its plain PyTorch
version and its autograd rule.

Replaces the Pallas TPU kernel ``nessai_tpu/ops/coupling_pallas.py``
(``affine_coupling_transform``, ``pl.pallas_call`` at line 56, and its
training wrapper ``affine_coupling_pallas_vjp``). The kernel is
``csrc/affine_coupling.cu``, built with nvcc for ``sm_90a`` and bound
with ctypes (see ``_build.py``).

What bounds it on an H100: bytes. A call moves 4·n·(4·d + 1) bytes
(x, raw_s, t read once; y and the row log-determinant written once) at
3.35 TB/s, with a few dozen operations per element. At the flagship's
shapes (d = 1, n of 10³..10⁴) that is nanoseconds, so the launch latency
sets its time.

:func:`affine_coupling` is the wrapper: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. There is no
fall-back from one to the other. Its gradient is the closed form in
:class:`AffineCouplingFunction` (the JAX package's backward is the
autodiff of its jnp reference, with no backward kernel either).
"""

import ctypes
import functools

import torch

__all__ = [
    "affine_coupling",
    "affine_coupling_plain",
    "AffineCouplingFunction",
]


def affine_coupling_plain(x, raw_s, t, inverse: bool = False, clamp: float = 5.0):
    """Plain PyTorch version: ``(y, log_det)`` with
    ``s = clamp * tanh(raw_s / clamp)``, ``y = x * exp(s) + t`` (or
    ``(x - t) * exp(-s)`` for the inverse) and ``log_det = ±sum(s, -1)``."""
    s = clamp * torch.tanh(raw_s / clamp)
    if inverse:
        return (x - t) * torch.exp(-s), -torch.sum(s, dim=-1)
    return x * torch.exp(s) + t, torch.sum(s, dim=-1)


def _check_inputs(x, raw_s, t) -> None:
    for name, a in (("x", x), ("raw_s", raw_s), ("t", t)):
        if a.dtype != torch.float32:
            raise TypeError(f"affine_coupling: {name} must be float32, got {a.dtype}")
        if a.dim() != 2:
            raise ValueError(f"affine_coupling: {name} must be [n, d], got {tuple(a.shape)}")
        if a.shape != x.shape:
            raise ValueError(
                f"affine_coupling: {name} has shape {tuple(a.shape)}, "
                f"x has {tuple(x.shape)}"
            )
        if a.device != x.device:
            raise ValueError(
                f"affine_coupling: {name} is on {a.device}, x on {x.device}"
            )


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/affine_coupling.cu``, built at first use."""
    from ._build import load

    fn = load("affine_coupling").affine_coupling_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, raw_s, t, inverse: bool, clamp: float):
    """Launch the CUDA kernel on PyTorch's current stream."""
    for a in (x, raw_s, t):
        if not a.is_contiguous():
            raise ValueError("affine_coupling: inputs must be contiguous")
    n, d = x.shape
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, ld
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(),
            raw_s.data_ptr(),
            t.data_ptr(),
            y.data_ptr(),
            ld.data_ptr(),
            n,
            d,
            float(clamp),
            int(bool(inverse)),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"affine_coupling kernel launch failed with cudaError {err}"
        )
    affine_coupling.launches += 1
    return y, ld


def _transform(x, raw_s, t, inverse: bool, clamp: float):
    if x.device.type == "cpu":
        return affine_coupling_plain(x, raw_s, t, inverse, clamp)
    if x.device.type == "cuda":
        return _launch(x, raw_s, t, inverse, clamp)
    raise RuntimeError(f"affine_coupling: no kernel for device {x.device}")


class AffineCouplingFunction(torch.autograd.Function):
    """Forward through the kernel (plain version on the CPU); backward in
    closed form. With ``th = tanh(raw_s / clamp)`` and ``s = clamp*th``:

    - forward:  dx = g·eˢ,  dt = g,       draw = (g·x·eˢ + g_ld)·(1 − th²)
    - inverse:  dx = g·e⁻ˢ, dt = −g·e⁻ˢ, draw = (−g·y − g_ld)·(1 − th²)
    """

    @staticmethod
    def forward(ctx, x, raw_s, t, inverse, clamp):
        y, ld = _transform(x, raw_s, t, inverse, clamp)
        ctx.inverse = bool(inverse)
        ctx.clamp = float(clamp)
        ctx.save_for_backward(x, raw_s, y)
        return y, ld

    @staticmethod
    def backward(ctx, g, g_ld):
        x, raw_s, y = ctx.saved_tensors
        th = torch.tanh(raw_s / ctx.clamp)
        s = ctx.clamp * th
        if g is None:
            g = torch.zeros_like(x)
        if g_ld is None:
            g_ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        dtanh = 1.0 - th * th
        if ctx.inverse:
            e = torch.exp(-s)
            gx = g * e
            gt = -gx
            graw = (-g * y - g_ld[:, None]) * dtanh
        else:
            e = torch.exp(s)
            gx = g * e
            gt = g
            graw = (g * x * e + g_ld[:, None]) * dtanh
        return gx, graw, gt, None, None


def affine_coupling(x, raw_s, t, inverse: bool = False, clamp: float = 5.0):
    """Fused affine coupling ``(x, raw_s, t) -> (y, log_det)`` on ``[n, d]``
    float32 tensors, differentiable in all three inputs.

    CUDA tensors launch ``csrc/affine_coupling.cu`` (each launch adds one
    to ``affine_coupling.launches``); CPU tensors use
    :func:`affine_coupling_plain`."""
    _check_inputs(x, raw_s, t)
    return AffineCouplingFunction.apply(
        x.contiguous(), raw_s.contiguous(), t.contiguous(), inverse, clamp
    )


#: Kernel launches since the count was last set to 0.
affine_coupling.launches = 0
