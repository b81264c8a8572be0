#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nessai_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each printing one JSON line: the environment; the nvcc build of
the kernels from ``nessai_tpu_torch/csrc`` (one nvcc per source, all at
once; ptxas's registers and spills of each kernel, and no spills
allowed); the affine-coupling kernel (K1) against its plain PyTorch version
(both directions, gradients, times), first as the bare transform, then
as the coupling layer with its backward kernel (also bitwise against the
unfused path of gathers, copies and the bare kernel, and timed against
it); the rational-quadratic spline
kernels (K2: forward, inverse and the backward of the forward, with
linear tails up to 40 bins and with ``tails=None`` on the unit box)
against theirs; the flagship RealNVP and the neural-spline flow, and
the flows the flagships do not build (LU and SVD linear layers, MAF, the
logit pre-transform, a LARS base, the unit-hypercube spline on a uniform
base), on the GPU against the same weights on the CPU; the importance nested sampler's
per-level flows (``log_prob_all`` and single-level passes at 16,384
rows) on the GPU against the CPU; the flagship nested-sampling run
(``bench.py``'s configuration) through ``FlowSampler(..., device="cuda")``,
the same run with the neural spline flow, the importance nested
sampler's flagship (``FlowSampler(..., importance_nested_sampler=True,
device="cuda")``), its Gaussian-mixture configuration with the final
redraw (``flagship_ins_mixture``) and capped runs of its flagship with
the weighted flow training and the bootstrap, and with replace_all and
the final flow (``ins_options``); every registered reparameterisation's
device inverse against the host's (``reparam_inverse_gpu_vs_cpu``, before the runs) and
the half-Gaussian and angle examples through the reparameterisations
(``flagship_reparam_inversion``, ``flagship_reparam_angle``); the
documented RealNVP with LU linear layers (``flagship_lu``) and the
importance nested sampler with its neural spline flow on the unit
hypercube (``tails=None``, a uniform base) on the 4-D Rosenbrock
likelihood (``flagship_ins_hypercube``); the egg-box example
(``flagship_eggbox``, to ``EGGBOX_SMOKE_ITERATIONS``: the reset every
8th training, the 18 modes) and the augmented-proposal example in full
(``flagship_augmented``); short runs of the standard sampler's options
(``standard_options_*``: the truncation rules, the likelihood split,
the iteration cap, the training schedule, the uninformed proposal, the
shrinkage, the optimisers and training options, the augmented marginal,
the unit hypercube); a ``kernels`` summary. The
last line is ``{"ok": true, "device": {...}}``. Any failing phase ends
the script with a non-zero exit code and without that line. Without a
GPU the script exits with code 2 at once. ``python3 chip_smoke.py
--eggbox-in-full`` builds the kernels and runs the egg-box example to
its end (about 40 minutes), with the pull's gate.

Imports nothing of JAX or of the JAX package.
"""

import functools
import json
import logging
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor)
#: operations/s; the bound of a kernel is the larger of bytes/rate and
#: operations/rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: samples of the bare K1's CUDA-event timings (30 until the egg-box and
#: option runs joined the script)
K1_EVENT_REPEATS = 10
#: K1 check shapes [n, d_tr]: the flagship's training batch (900 rows
#: after the 10% validation split), its validation pass (100 rows) and
#: pool draws (1000 and more, d_tr = 1), and wider layers.
K1_SHAPES = [
    (900, 1),
    (100, 1),
    (1000, 1),
    (4096, 1),
    (16384, 1),
    (13, 3),
    (1000, 8),
    (65536, 16),
]
#: K1 layer check shapes (n, D, mask; 1 marks an identity column): the
#: flagship's couplings (D = 2, both masks) at its training batch and
#: validation pass, a mask in no order with three transformed columns,
#: alternating masks at widths that take 16-byte loads, and the
#: importance nested sampler's pass over every stored sample (16,384
#: rows) and its final redraw's ``log_prob_all`` batches (20,000 rows),
#: then the reparameterisation runs' training batches of 1000 rows at
#: D = 2 and D = 3 (the angle run's alternating masks), then the
#: augmented proposal's 4-D flow (two real and two augment columns, the
#: fixed mask) at 2000 rows; new rows go last, so that the rows before
#: them keep their inputs
K1_LAYER_SHAPES = [
    (900, 2, (1, 0)),
    (900, 2, (0, 1)),
    (100, 2, (1, 0)),
    (13, 5, (1, 0, 0, 1, 0)),
    (4096, 8, (1, 0) * 4),
    (65536, 32, (1, 0) * 16),
    (16384, 2, (1, 0)),
    (20000, 2, (1, 0)),
    (1000, 2, (1, 0)),
    (1000, 3, (0, 1, 0)),
    (1000, 3, (1, 0, 1)),
    (2000, 4, (1, 1, 0, 0)),
]
#: shape of the kernels-line numbers of both K1 kernels: a flagship
#: training step's coupling
K1_LAYER_MAIN_SHAPE = (900, 2, (1, 0))
#: calls in each profile of the plain and unfused paths of the coupling
#: layer (11-39 GPU records a call); the fused kernels keep 200
K1_LAYER_OTHER_PROFILE_CALLS = 50
#: the rows whose plain and unfused paths are timed too (the flagship's
#: training step and the augmented flow's); every row times the fused
#: kernels and checks all three paths (profiler sessions cut for the time
#: limit when the egg-box and option runs joined the script)
K1_LAYER_TIMED_SHAPES = (K1_LAYER_MAIN_SHAPE, (2000, 4, (1, 1, 0, 0)))
Y_ATOL, Y_RTOL, LD_ATOL = 1e-6, 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
FLOW_ATOL, FLOW_RTOL = 1e-5, 1e-5
PULL_LIMIT = 3.0
#: the importance nested sampler's flow check: levels and rows
INS_LEVELS, INS_ROWS = 4, 16384

#: K2 check shapes [n, d_tr, K]: the NSF flagship's training batch, its
#: validation pass and pool draws (d_tr = 1, 8 bins), wider layers, one
#: shape with 4 bins and one with 11 (not a power of two: 16-lane groups
#: with 5 lanes idle).
K2_SHAPES = [
    (900, 1, 8),
    (100, 1, 8),
    (1000, 1, 8),
    (4096, 1, 8),
    (16384, 1, 8),
    (13, 3, 8),
    (65536, 16, 8),
    (4096, 2, 4),
    (2048, 3, 11),
]
#: K2 rows after those (their inputs drawn after the rows above, so those
#: keep theirs), with their tails: linear tails at more bins than a
#: 16-lane group holds (24 and 32: one warp an element; 40: chunks of 32
#: bins), then tails=None (the unit box, K + 1 learned derivatives) at
#: the unit-hypercube run's shapes: a training batch of 1000 rows with
#: its two transformed columns (forward and backward), a level's draws of
#: 10,000 rows (inverse) and 10^6 elements
K2_SHAPES_MORE = [
    (2048, 2, 24, "linear"),
    (2048, 2, 32, "linear"),
    (2048, 2, 40, "linear"),
    (1000, 2, 8, None),
    (10000, 2, 8, None),
    (500000, 2, 8, None),
]
#: shape of the kernels-line numbers: an NSF flagship training step
K2_MAIN_SHAPE = (900, 1, 8)
#: and of the tails=None variant's: a training step of the unit-hypercube run
K2_UNIT_MAIN_SHAPE = (1000, 2, 8)
TAIL_BOUND = 5.0
#: The kernels compute in double between float32 loads and stores, so
#: each output is the float32 rounding of the plain version run in
#: float64 on the same inputs: held to about 16 ulp.
K2_F64_ATOL = K2_F64_RTOL = 1e-6
#: Against the plain version in float32, which strays from float64 by
#: up to 1.4e-3 in the log-derivative and 5e-4 in y over 10^6 elements
#: (float32 knots round to an ulp of the tail bound, and narrow, steep
#: bins amplify that): y atol, log-derivative atol, and gradients as a
#: share of the largest plain gradient.
K2_F32_Y_ATOL, K2_F32_LD_ATOL, K2_F32_GRAD_SHARE = 2e-3, 1e-2, 1e-3
#: Round trip: the float32 rounding of y, stretched by the inverse's slope
#: 1 + exp(-ld): x to 1e-6, the log-derivatives' sum to 1e-3 of it.
K2_RT_X, K2_RT_LD = 1e-6, 1e-3
#: K2's timing runs: the plain version launches 90-184 kernels a call, so
#: its profiles take 20 calls, and only at the two main shapes (the
#: kernels are timed at every shape with 200 calls; the plain version
#: was timed at every shape with 50 until the egg-box and option runs
#: joined the script)
K2_PLAIN_PROFILE_CALLS = 20
K2_EVENT_TIMING = dict(inner=10, repeats=10)
#: weight perturbation of the NSF in the flow check: the splines move
#: away from the identity (log-derivatives of order 1)
NSF_FLOW_PERTURBATION = 0.1
#: The reparameterisations' device inverse (every registered name) on
#: the card against the host's float64 inverse of the same float32 x',
#: at the rows of a populate round of the runs below: each x column to
#: ``REPARAM_X_TOL`` and each log-Jacobian to ``REPARAM_LJ_TOL`` of
#: (1 + |reference|). The float32 inverse strays by up to 4e-7 in x on
#: the CPU; its log-Jacobian by up to 4.4e-4 where a sigmoid's 1 - y is
#: rounded near y = 1 (``dequantise-logit``), as the JAX package's float32
#: inverse does.
REPARAM_ROWS = 65536
REPARAM_X_TOL, REPARAM_LJ_TOL = 1e-5, 1e-3
#: what ``ms`` and ``plain_ms`` are where the profiler sees no GPU work
EVENT_FALLBACK = (
    "where the profiler records no GPU work, CUDA-event time per call over "
    "the same back-to-back calls (GPU time plus launch gaps, so an upper bound)"
)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, inner=50, repeats=30, warmup=5):
    """Median over ``repeats`` of CUDA-event time per call, each sample
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def k1_bound_ms(n, d):
    n_bytes = 4 * n * (4 * d + 1)
    # per element: divide, tanh, multiply, exp, multiply, add, row-sum add
    n_ops = 7 * n * d
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k1_layer_bound_ms(n, D, n_tr, backward=False, inverse=False):
    """Least time for the coupling layer. Forward: x, raw_s, t read and y,
    ld written, 4 n (2 D + 2 n_tr + 1) bytes; 7 operations per transformed
    element. Backward: g_y, g_ld, x (transformed columns), raw_s and, for
    the inverse, t read; g_x, g_raw, g_t written; 11 operations per
    transformed element, 17 for the inverse (which recomputes y)."""
    if backward:
        n_bytes = 4 * n * (2 * D + 1 + n_tr * (5 if inverse else 4))
        n_ops = (17 if inverse else 11) * n * n_tr
    else:
        n_bytes = 4 * n * (2 * D + 2 * n_tr + 1)
        n_ops = 7 * n * n_tr
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k2_bound_ms(x, K, backward=False, tails="linear"):
    """Least time for the spline on this data: bytes (x and the outputs
    for every element, the 3K - 1 parameters (3K + 1 for tails=None) only
    where x is inside the box) against float32 operations (about 21K + 45
    per inside element forward, 31K + 105 backward; none outside)."""
    m = x.numel()
    lo, hi = (-TAIL_BOUND, TAIL_BOUND) if tails == "linear" else (0.0, 1.0)
    n_params = 3 * K - 1 if tails == "linear" else 3 * K + 1
    inside = int(((x >= lo) & (x <= hi)).sum().item())
    if backward:
        # x, gy, gl read; dx, dw, dh, dd written for every element
        n_bytes = 4 * (3 * m + n_params * inside + n_params * m + m)
        n_ops = (31 * K + 105) * inside
    else:
        n_bytes = 4 * (3 * m + n_params * inside)
        n_ops = (21 * K + 45) * inside
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    capability = torch.cuda.get_device_capability(0)
    emit(
        "environment",
        nvidia_smi=smi,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=sys.version.split()[0],
        capability=list(capability),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    if capability != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {capability}")
    return smi


def phase_build():
    from nessai_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    # ptxas's registers and spills of every kernel
    kernels = {name: _build.resources(name) for name in libs}
    emit(
        "build",
        seconds=seconds,
        flags=" ".join(_build.NVCC_FLAGS),
        library=os.path.basename(str(libs["affine_coupling"])),
        libraries={k: os.path.basename(str(v)) for k, v in libs.items()},
        ptxas=kernels,
    )
    spilled = [
        k["kernel"]
        for found in kernels.values()
        for k in found
        if k["spill_store_bytes"] or k["spill_load_bytes"]
    ]
    if spilled or not all(kernels.values()):
        raise RuntimeError(f"ptxas reports spills in {spilled} or no kernels: {kernels}")


def phase_k1():
    from nessai_tpu_torch.ops import coupling
    from nessai_tpu_torch.utils.profiling import device_time_ms

    gen = torch.Generator(device="cuda").manual_seed(20261016)
    rows = []
    max_err = 0.0
    for n, d in K1_SHAPES:
        x = torch.randn(n, d, device="cuda", generator=gen)
        raw_s = 2.0 * torch.randn(n, d, device="cuda", generator=gen)
        t = torch.randn(n, d, device="cuda", generator=gen)
        row = {"n": n, "d": d}
        for inverse in (False, True):
            tag = "inverse" if inverse else "forward"
            with torch.no_grad():
                y, ld = coupling.affine_coupling(x, raw_s, t, inverse)
                y_ref, ld_ref = coupling.affine_coupling_plain(x, raw_s, t, inverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, y_ref, atol=Y_ATOL, rtol=Y_RTOL)
            torch.testing.assert_close(ld, ld_ref, atol=LD_ATOL, rtol=0.0)
            err = max(
                (y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item()
            )
            max_err = max(max_err, err)
            # gradients: the autograd.Function against autograd of the
            # plain version, for a random linear loss of both outputs
            w_y = torch.randn(n, d, device="cuda", generator=gen)
            w_ld = torch.randn(n, device="cuda", generator=gen)
            grads = []
            for f in (coupling.affine_coupling, coupling.affine_coupling_plain):
                args = [a.clone().requires_grad_(True) for a in (x, raw_s, t)]
                yy, ll = f(*args, inverse)
                ((yy * w_y).sum() + (ll * w_ld).sum()).backward()
                grads.append([a.grad for a in args])
            for g_k, g_p in zip(*grads):
                torch.testing.assert_close(g_k, g_p, atol=GRAD_ATOL, rtol=GRAD_RTOL)
            kernel = functools.partial(coupling._launch, x, raw_s, t, inverse, 5.0)
            plain = functools.partial(coupling.affine_coupling_plain, x, raw_s, t, inverse)
            ms, _, timer = device_time_ms(kernel)
            plain_ms, plain_kernels, plain_timer = device_time_ms(plain)
            bound, bound_by = k1_bound_ms(n, d)
            row[tag] = {
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "timer": timer,
                "plain_timer": plain_timer,
                "plain_kernels_per_call": plain_kernels,
                "call_ms": time_ms(kernel, repeats=K1_EVENT_REPEATS),
                "plain_call_ms": time_ms(plain, repeats=K1_EVENT_REPEATS),
                "bound_ms": bound,
                "bound_by": bound_by,
            }
        with torch.no_grad():
            z, ld_f = coupling.affine_coupling(x, raw_s, t, False)
            x_back, ld_i = coupling.affine_coupling(z, raw_s, t, True)
        torch.testing.assert_close(x_back, x, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(ld_f + ld_i, torch.zeros_like(ld_f), atol=1e-5, rtol=0)
        row["round_trip_max_abs_err"] = (x_back - x).abs().max().item()
        rows.append(row)
    emit(
        "k1_vs_plain",
        tolerance={"y_atol": Y_ATOL, "y_rtol": Y_RTOL, "ld_atol": LD_ATOL,
                   "grad_atol": GRAD_ATOL, "grad_rtol": GRAD_RTOL},
        timing=(
            "ms, plain_ms: GPU kernel time per call from torch.profiler over "
            f"200 calls, or {EVENT_FALLBACK} (timer, plain_timer); call_ms, "
            f"plain_call_ms: CUDA-event time per call, median of {K1_EVENT_REPEATS} samples "
            "of 50 back-to-back calls"
        ),
        shapes=rows,
    )
    return max_err


class _UnfusedCoupling(torch.autograd.Function):
    """The bare K1 as an unfused coupling layer uses it: the kernel
    forward, and a backward in closed form as torch ops on the saved
    output (``affine_coupling_backward_plain``)."""

    @staticmethod
    def forward(ctx, x, raw_s, t, inverse):
        from nessai_tpu_torch.ops import coupling

        y, ld = coupling._launch(x, raw_s, t, inverse, 5.0)
        ctx.inverse = inverse
        ctx.save_for_backward(x, raw_s, t, y)
        return y, ld

    @staticmethod
    def backward(ctx, g, g_ld):
        from nessai_tpu_torch.ops import coupling

        x, raw_s, t, y = ctx.saved_tensors
        grads = coupling.affine_coupling_backward_plain(x, raw_s, t, y, g, g_ld, ctx.inverse, 5.0)
        return (*grads, None)


def _unfused_layer(x, out, columns, inverse):
    """The coupling layer without the fused kernel: the two column
    gathers, copies of the halves of ``out``, the bare K1, the
    concatenation and the scatter."""
    identity_idx, transform_idx, scatter_idx = columns
    n_tr = transform_idx.numel()
    x_id = x[:, identity_idx]
    y_tr, ld = _UnfusedCoupling.apply(
        x[:, transform_idx], out[:, :n_tr].contiguous(), out[:, n_tr:].contiguous(), inverse
    )
    return torch.cat([x_id, y_tr], dim=1)[:, scatter_idx], ld


def _columns(mask):
    mask = np.asarray(mask)
    identity_idx = np.flatnonzero(mask > 0)
    transform_idx = np.flatnonzero(mask <= 0)
    scatter_idx = np.argsort(np.concatenate([identity_idx, transform_idx]))
    return [torch.as_tensor(a, device="cuda") for a in (identity_idx, transform_idx, scatter_idx)]


def _grads(f, x, out, cot):
    xg, og = x.clone().requires_grad_(True), out.clone().requires_grad_(True)
    y, ld = f(xg, og)
    return torch.autograd.grad((y, ld), (xg, og), cot)


def _bitwise(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def phase_k1_layer():
    """The coupling-layer kernels (forward/inverse and backward) against
    their plain versions, and bitwise against the unfused path (gathers,
    copies and the bare K1 forward; the closed form as torch ops backward)
    that the fused kernels replace."""
    from nessai_tpu_torch.ops import coupling
    from nessai_tpu_torch.utils.profiling import device_time_ms

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    rows = []
    max_err = {"affine_coupling": 0.0, "affine_coupling_backward": 0.0}
    main = {}
    for n, D, mask in K1_LAYER_SHAPES:
        columns = _columns(mask)
        tidx = columns[1].to(torch.int32)
        n_tr = tidx.numel()
        x = torch.randn(n, D, device="cuda", generator=gen)
        out = torch.randn(n, 2 * n_tr, device="cuda", generator=gen)
        out[:, :n_tr] *= 2.0
        cot = (torch.randn(n, D, device="cuda", generator=gen), torch.randn(n, device="cuda", generator=gen))
        row = {"n": n, "D": D, "mask": list(mask)}
        for inverse in (False, True):
            tag = "inverse" if inverse else "forward"
            with torch.no_grad():
                y, ld = coupling.affine_coupling_layer(x, out, tidx, inverse)
                y_ref, ld_ref = coupling.affine_coupling_layer_plain(x, out, tidx, inverse)
                y_unf, ld_unf = _unfused_layer(x, out, columns, inverse)
                # the exact function, for the record: how far the kernel
                # and the float32 plain version each are from it
                y64, _ = coupling.affine_coupling_layer_plain(x.double(), out.double(), tidx, inverse)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, y_ref, atol=Y_ATOL, rtol=Y_RTOL)
            torch.testing.assert_close(ld, ld_ref, atol=LD_ATOL, rtol=0.0)
            if not _bitwise((y, ld), (y_unf, ld_unf)):
                raise RuntimeError(f"k1 layer at {(n, D, mask)} {tag}: not bitwise equal to the unfused path")
            err = max(_max_err(y, y_ref), _max_err(ld, ld_ref))
            max_err["affine_coupling"] = max(max_err["affine_coupling"], err)
            # backward: autograd through the fused op (the backward kernel)
            # against autograd of the plain version, and bitwise against
            # the unfused op sequence
            g_k = _grads(lambda a, b: coupling.affine_coupling_layer(a, b, tidx, inverse), x, out, cot)
            g_p = _grads(lambda a, b: coupling.affine_coupling_layer_plain(a, b, tidx, inverse), x, out, cot)
            g_u = _grads(lambda a, b: _unfused_layer(a, b, columns, inverse), x, out, cot)
            torch.cuda.synchronize()
            for a, b in zip(g_k, g_p):
                torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
            grad_err = max(_max_err(a, b) for a, b in zip(g_k, g_p))
            max_err["affine_coupling_backward"] = max(max_err["affine_coupling_backward"], grad_err)
            # times: the fused kernels, the plain versions and the unfused path
            xg, og = x.clone().requires_grad_(True), out.clone().requires_grad_(True)
            graph = _unfused_layer(xg, og, columns, inverse)
            timed_calls = {
                "forward_fused": functools.partial(coupling._launch_layer, x, out, tidx, inverse, 5.0),
                "forward_plain": functools.partial(coupling.affine_coupling_layer_plain, x, out, tidx, inverse),
                "forward_unfused": functools.partial(_unfused_layer, x, out, columns, inverse),
                "backward_fused": functools.partial(
                    coupling._launch_layer_backward, x, out, tidx, *cot, inverse, 5.0
                ),
                "backward_plain": functools.partial(
                    coupling.affine_coupling_layer_backward_plain, x, out, tidx, *cot, inverse
                ),
                "backward_unfused": functools.partial(
                    torch.autograd.grad, graph, (xg, og), cot, retain_graph=True
                ),
            }
            with torch.no_grad():
                times = {
                    name: device_time_ms(call) if name in ("forward_fused", "backward_fused")
                    else device_time_ms(call, calls=K1_LAYER_OTHER_PROFILE_CALLS)
                    if (n, D, mask) in K1_LAYER_TIMED_SHAPES else (None, None, None)
                    for name, call in timed_calls.items()
                }
            del graph, timed_calls
            fwd_bound, fwd_by = k1_layer_bound_ms(n, D, n_tr)
            bwd_bound, bwd_by = k1_layer_bound_ms(n, D, n_tr, backward=True, inverse=inverse)
            row[tag] = {
                "max_abs_err": err,
                "y_max_abs_err_vs_float64": _max_err(y, y64),
                "plain_y_max_abs_err_vs_float64": _max_err(y_ref, y64),
                "backward_max_abs_err": grad_err,
                "backward_bitwise_equal_to_unfused_ops": _bitwise(g_k, g_u),
                "backward_max_abs_diff_from_unfused_ops": max(_max_err(a, b) for a, b in zip(g_k, g_u)),
                **{f"{k}_ms": v[0] for k, v in times.items()},
                **{f"{k}_records_per_call": v[1] for k, v in times.items()},
                "timers": sorted({v[2] for v in times.values() if v[2]}),
                "bound_ms": fwd_bound,
                "bound_by": fwd_by,
                "backward_bound_ms": bwd_bound,
                "backward_bound_by": bwd_by,
            }
            if (n, D, mask) == K1_LAYER_MAIN_SHAPE and not inverse:
                r = row[tag]
                main["affine_coupling"] = dict(
                    ms=r["forward_fused_ms"], plain_ms=r["forward_plain_ms"],
                    bound_ms=fwd_bound, bound_by=fwd_by, timer=times["forward_fused"][2],
                    plain_timer=times["forward_plain"][2],
                )
                main["affine_coupling_backward"] = dict(
                    ms=r["backward_fused_ms"], plain_ms=r["backward_plain_ms"],
                    bound_ms=bwd_bound, bound_by=bwd_by, timer=times["backward_fused"][2],
                    plain_timer=times["backward_plain"][2],
                )
        rows.append(row)
    emit(
        "k1_layer_vs_plain",
        tolerance={"y_atol": Y_ATOL, "y_rtol": Y_RTOL, "ld_atol": LD_ATOL,
                   "grad_atol": GRAD_ATOL, "grad_rtol": GRAD_RTOL,
                   "forward_vs_unfused_path": "bitwise"},
        timing=(
            "*_ms, *_records_per_call: GPU time and GPU records per call from "
            f"torch.profiler over 200 calls (fused) or {K1_LAYER_OTHER_PROFILE_CALLS} "
            f"(plain, unfused; None outside {list(K1_LAYER_TIMED_SHAPES)}), or {EVENT_FALLBACK} "
            "(timers); fused: "
            "the layer kernels; plain: affine_coupling_layer_plain and "
            "affine_coupling_layer_backward_plain; unfused: the path the fused "
            "kernels replace (gathers, "
            "copies and the bare K1 forward; autograd of it with the closed form "
            "as torch ops backward)"
        ),
        shapes=rows,
    )
    return max_err, main


def _k2_inputs(gen, n, d, K, tails="linear"):
    """x ~ U(-6, 6) (tails covered; U(-0.1, 1.1) for tails=None), raw
    parameters ~ N(0, 1), the parameters as the slices of one [n, d,
    3K - 1] (3K + 1) conditioner output that the coupling passes
    (strided views, as on the main path)."""
    if tails == "linear":
        x = 12.0 * torch.rand(n, d, device="cuda", generator=gen) - 6.0
        out = torch.randn(n, d, 3 * K - 1, device="cuda", generator=gen)
    else:
        x = 1.2 * torch.rand(n, d, device="cuda", generator=gen) - 0.1
        out = torch.randn(n, d, 3 * K + 1, device="cuda", generator=gen)
    return x, out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]


def _max_err(a, b):
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def phase_k2():
    from nessai_tpu_torch.ops.rqs import _launch, _launch_backward, rqs, rqs_plain
    from nessai_tpu_torch.utils.profiling import device_time_ms

    gen = torch.Generator(device="cuda").manual_seed(20261017)
    rows = []
    max_err = {"rqs": 0.0, "rqs_backward": 0.0, "rqs_unit": 0.0, "rqs_unit_backward": 0.0}
    main = {}
    for n, d, K, tails in [(n, d, K, "linear") for n, d, K in K2_SHAPES] + K2_SHAPES_MORE:
        row_start = time.perf_counter()
        x, w, h, dd = _k2_inputs(gen, n, d, K, tails)
        x64 = [a.double() for a in (x, w, h, dd)]
        row = {"n": n, "d": d, "K": K, "tails": tails}
        kind = "rqs" if tails == "linear" else "rqs_unit"
        is_main = (n, d, K) == (K2_MAIN_SHAPE if tails == "linear" else K2_UNIT_MAIN_SHAPE)
        for inverse in (False, True):
            tag = "inverse" if inverse else "forward"
            with torch.no_grad():
                before = rqs.launches
                y, ld = rqs(x, w, h, dd, inverse, TAIL_BOUND, tails)
                launches = rqs.launches - before
                y64, ld64 = rqs_plain(*x64, inverse, TAIL_BOUND, tails)
                y32, ld32 = rqs_plain(x, w, h, dd, inverse, TAIL_BOUND, tails)
            torch.cuda.synchronize()
            if tails is None:
                # the outputs of inputs inside the unit box stay inside it
                box = (x >= 0.0) & (x <= 1.0)
                if not bool(((y[box] >= 0.0) & (y[box] <= 1.0)).all()):
                    raise RuntimeError(f"rqs at {(n, d, K, tails)}, inverse={inverse}: y leaves the unit box")
            torch.testing.assert_close(y.double(), y64, atol=K2_F64_ATOL, rtol=K2_F64_RTOL)
            torch.testing.assert_close(ld.double(), ld64, atol=K2_F64_ATOL, rtol=K2_F64_RTOL)
            torch.testing.assert_close(y, y32, atol=K2_F32_Y_ATOL, rtol=0.0)
            torch.testing.assert_close(ld, ld32, atol=K2_F32_LD_ATOL, rtol=0.0)
            err = max(_max_err(y, y64), _max_err(ld, ld64))
            max_err[kind] = max(max_err[kind], err)
            kernel = functools.partial(_launch, x, w, h, dd, inverse, TAIL_BOUND, tails)
            plain = functools.partial(rqs_plain, x, w, h, dd, inverse, TAIL_BOUND, tails)
            ms, _, timer = device_time_ms(kernel)
            plain_ms, plain_kernels, plain_timer = (
                device_time_ms(plain, calls=K2_PLAIN_PROFILE_CALLS) if is_main else (None, None, None)
            )
            bound, bound_by = k2_bound_ms(x, K, tails=tails)
            row[tag] = {
                "launches_per_call": launches,
                "max_abs_err": err,
                "max_abs_err_vs_float32_plain": max(_max_err(y, y32), _max_err(ld, ld32)),
                "ms": ms,
                "plain_ms": plain_ms,
                "timer": timer,
                "plain_timer": plain_timer,
                "plain_kernels_per_call": plain_kernels,
                "call_ms": time_ms(kernel, **K2_EVENT_TIMING),
                "plain_call_ms": time_ms(plain, **K2_EVENT_TIMING) if is_main else None,
                "bound_ms": bound,
                "bound_by": bound_by,
            }
            if is_main and not inverse:
                main[kind] = row[tag]
        # backward of the forward: the kernel against autograd of the
        # plain version (float64, and float32 as a share of the largest
        # plain gradient), for a random linear loss of both outputs
        w_y = torch.randn(n, d, device="cuda", generator=gen)
        w_ld = torch.randn(n, d, device="cuda", generator=gen)
        grads = {}
        graphs = {}
        before = rqs.backward_launches
        for name, f, dtype in (
            ("kernel", rqs, torch.float32),
            ("plain64", rqs_plain, torch.float64),
            ("plain32", rqs_plain, torch.float32),
        ):
            args = [a.detach().to(dtype).requires_grad_(True) for a in (x, w, h, dd)]
            yy, ll = f(*args, False, TAIL_BOUND, tails)
            cot = (w_y.to(dtype), w_ld.to(dtype))
            grads[name] = torch.autograd.grad((yy, ll), args, cot, retain_graph=True)
            graphs[name] = (yy, ll, args, cot)
        torch.cuda.synchronize()
        backward_launches = rqs.backward_launches - before
        share = 0.0
        for g_k, g_64, g_32 in zip(grads["kernel"], grads["plain64"], grads["plain32"]):
            torch.testing.assert_close(g_k.double(), g_64, atol=K2_F64_ATOL, rtol=K2_F64_RTOL)
            if g_32.numel():
                scale = g_32.abs().max().item()
                share = max(share, _max_err(g_k, g_32) / max(scale, 1e-30))
        if share > K2_F32_GRAD_SHARE:
            raise RuntimeError(
                f"rqs_backward at {(n, d, K, tails)} differs from the float32 plain gradient by "
                f"{share} of its largest entry (limit {K2_F32_GRAD_SHARE})"
            )
        err = max(_max_err(a, b) for a, b in zip(grads["kernel"], grads["plain64"]))
        max_err[kind + "_backward"] = max(max_err[kind + "_backward"], err)
        yy, ll, args, cot = graphs["plain32"]
        kernel = functools.partial(_launch_backward, x, w, h, dd, w_y, w_ld, TAIL_BOUND, tails)
        plain = functools.partial(torch.autograd.grad, (yy, ll), args, cot, retain_graph=True)
        ms, _, timer = device_time_ms(kernel)
        plain_ms, plain_kernels, plain_timer = (
            device_time_ms(plain, calls=K2_PLAIN_PROFILE_CALLS) if is_main else (None, None, None)
        )
        bound, bound_by = k2_bound_ms(x, K, backward=True, tails=tails)
        row["backward"] = {
            "launches_per_call": backward_launches,
            "max_abs_err": err,
            "max_share_of_largest_float32_plain_gradient": share,
            "ms": ms,
            "plain_ms": plain_ms,
            "timer": timer,
            "plain_timer": plain_timer,
            "plain_kernels_per_call": plain_kernels,
            "call_ms": time_ms(kernel, **K2_EVENT_TIMING),
            "plain_call_ms": time_ms(plain, **K2_EVENT_TIMING) if is_main else None,
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        if is_main:
            main[kind + "_backward"] = row["backward"]
        del graphs, grads
        # forward -> inverse round trip through the kernel
        with torch.no_grad():
            z, ld_f = rqs(x, w, h, dd, False, TAIL_BOUND, tails)
            x_back, ld_i = rqs(z, w, h, dd, True, TAIL_BOUND, tails)
        slope = 1.0 + torch.exp(-ld_f.double())
        rt_x = ((x_back - x).abs() / slope).max().item()
        rt_ld = ((ld_f + ld_i).abs() / slope).max().item()
        if not (rt_x <= K2_RT_X and rt_ld <= K2_RT_LD):
            raise RuntimeError(
                f"rqs round trip at {(n, d, K, tails)}: x {rt_x} (limit {K2_RT_X}), "
                f"log-derivative {rt_ld} (limit {K2_RT_LD}), in units of 1 + exp(-ld)"
            )
        row["round_trip"] = {
            "max_abs_err_x": _max_err(x_back, x),
            "max_abs_err_ld": (ld_f + ld_i).abs().max().item(),
            "max_x_err_over_slope": rt_x,
            "max_ld_err_over_slope": rt_ld,
        }
        row["seconds"] = time.perf_counter() - row_start
        rows.append(row)
    emit(
        "k2_vs_plain",
        tolerance={
            "vs_float64_plain_atol": K2_F64_ATOL,
            "vs_float64_plain_rtol": K2_F64_RTOL,
            "vs_float32_plain_y_atol": K2_F32_Y_ATOL,
            "vs_float32_plain_ld_atol": K2_F32_LD_ATOL,
            "vs_float32_plain_grad_share_of_max": K2_F32_GRAD_SHARE,
            "round_trip_x_per_slope": K2_RT_X,
            "round_trip_ld_per_slope": K2_RT_LD,
        },
        timing=(
            "ms, plain_ms: GPU time per call from torch.profiler over 200 kernel "
            f"calls and {K2_PLAIN_PROFILE_CALLS} plain calls (plain: float32, "
            f"backward = autograd of the plain graph; at {K2_MAIN_SHAPE} and "
            f"{K2_UNIT_MAIN_SHAPE} only, None elsewhere), or {EVENT_FALLBACK} "
            "(timer, plain_timer); call_ms, plain_call_ms: "
            f"CUDA-event time per call, median of {K2_EVENT_TIMING['repeats']} "
            f"samples of {K2_EVENT_TIMING['inner']} back-to-back calls"
        ),
        shapes=rows,
    )
    return max_err, main


def _flagship_flow(device, config, seed=0, dims=2):
    from nessai_tpu_torch.flows import configure_model

    flow = configure_model(dict(config["flow_config"], n_inputs=dims, seed=seed))
    return flow.to(device)


def phase_flow(config, name, scale, seed=7, reference_dtype=torch.float32, dims=2, inputs="normal"):
    """The flagship's flow (``config``, on ``dims`` dimensions) on the GPU
    against the same weights on the CPU in ``reference_dtype``, every
    weight perturbed by ``scale`` so that the couplings are not the
    identity; ``inputs="unit"`` feeds it points of the unit hypercube (the
    domain of a logit pre-transform or of a flow on the unit box)."""
    flow_gpu = _flagship_flow("cuda", config, dims=dims)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        # move every weight away from the zero-initialised last layers
        for p in flow_gpu.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen).to(p.device))
    flow_cpu = _flagship_flow("cpu", config, dims=dims)
    flow_cpu.load_state_dict({k: v.cpu() for k, v in flow_gpu.state_dict().items()})
    flow_cpu.to(reference_dtype)
    if inputs == "unit":
        x = torch.as_tensor(np.random.default_rng(seed + 4).uniform(0.001, 0.999, (4096, dims)), dtype=torch.float32)
    else:
        # inputs in the range the flagship feeds the flow: z-scored live
        # points and latents truncated at a radius of a few sigma. (The
        # float32 error of log q grows with |z| · error(z): at |z| ~ 8 it
        # reaches 1e-5 on either device.)
        x = np.random.default_rng(seed + 4).normal(0, 1, (6000, dims))
        x = torch.as_tensor(x[np.linalg.norm(x, axis=1) <= 3.0][:4096], dtype=torch.float32)
    errs = {}
    shares = {}
    largest = {}
    with torch.no_grad():
        for method, f in (
            ("forward", lambda fl, a: fl(a)),
            ("inverse", lambda fl, a: fl.inverse(a)),
            ("log_prob", lambda fl, a: (fl.log_prob(a),)),
        ):
            out_gpu = f(flow_gpu, x.cuda())
            out_cpu = f(flow_cpu, x.to(reference_dtype))
            err = share = 0.0
            for a, b in zip(out_gpu, out_cpu):
                a = a.cpu().to(reference_dtype)
                torch.testing.assert_close(a, b, atol=FLOW_ATOL, rtol=FLOW_RTOL)
                diff = (a - b).abs()
                err = max(err, diff.max().item())
                share = max(share, (diff / (FLOW_ATOL + FLOW_RTOL * b.abs())).max().item())
            errs[method] = err
            shares[method] = share
            largest[method] = max(b.abs().max().item() for b in out_cpu)
        # how far the perturbed flow is from its permutations alone
        z_cpu, _ = flow_cpu(x.to(reference_dtype))
    perm = x.to(reference_dtype)
    for b in flow_cpu.bijector.bijectors:
        if hasattr(b, "perm"):
            perm = perm[:, b.perm]
    emit(
        "flow_gpu_vs_cpu",
        flow=name,
        n=len(x),
        dims=dims,
        inputs=inputs,
        flow_config=config["flow_config"],
        weight_perturbation=scale,
        reference_dtype=str(reference_dtype),
        atol=FLOW_ATOL,
        rtol=FLOW_RTOL,
        max_abs_err=errs,
        max_share_of_tolerance=shares,
        max_abs_value=largest,
        max_abs_distance_from_permutation=(z_cpu - perm).abs().max().item(),
    )


def _ins_flow_model(device, seed=11):
    """An ``ImportanceFlowModel`` of the INS flagship's flow with
    ``INS_LEVELS`` levels on ``device``, each level's weights those of a
    new flow perturbed by 0.05 N(0, 1) (so that no coupling is the
    identity), drawn from ``seed``."""
    from nessai_tpu_torch.flowmodel import ImportanceFlowModel

    fm = ImportanceFlowModel(dict(n_inputs=2), output=tempfile.gettempdir(),
                             rng=np.random.default_rng(seed), device=device)
    fm.initialise()
    gen = torch.Generator().manual_seed(seed)
    for _ in range(INS_LEVELS):
        fm.add_new_flow(reset=True)
        with torch.no_grad():
            for p in fm.flow.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
        fm.add_level(fm.flow)
    return fm


def phase_ins_flow():
    """The importance nested sampler's levels on the GPU against the same
    weights on the CPU: ``log_prob_all`` over every level and the
    single-level pass of ``update_log_q`` at ``INS_ROWS`` rows, with GPU
    time and K1 launches per call."""
    from nessai_tpu_torch.flows.convert import levels_from_jax, params_to_jax
    from nessai_tpu_torch.ops import coupling
    from nessai_tpu_torch.utils.profiling import device_time_ms

    gpu = _ins_flow_model("cuda")
    cpu = _ins_flow_model("cpu")
    levels_from_jax(cpu, [params_to_jax(level) for level in gpu.models])
    # logit-space rows as the levels see them, within a radius of 3
    x = np.random.default_rng(12).normal(0, 1, (2 * INS_ROWS, 2))
    x = x[np.linalg.norm(x, axis=1) <= 3.0][:INS_ROWS]
    x_gpu = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    rows = {}
    calls = {
        "log_prob_all": (lambda fm, a: fm.log_prob_all(a),
                         lambda: torch.stack([f.log_prob(x_gpu) for f in gpu.models], dim=1)),
        "log_prob_ith": (lambda fm, a: fm.log_prob_ith(a, INS_LEVELS - 1),
                         lambda: gpu.models[-1].log_prob(x_gpu)),
    }
    for name, (call, device_call) in calls.items():
        coupling.affine_coupling.launches = 0
        ours = call(gpu, x)
        launches = coupling.affine_coupling.launches
        theirs = call(cpu, x)
        np.testing.assert_allclose(ours, theirs, atol=FLOW_ATOL, rtol=FLOW_RTOL)
        with torch.no_grad():
            ms, records, timer = device_time_ms(device_call, calls=50)
            start = time.perf_counter()
            for _ in range(20):
                call(gpu, x)
            host_ms = (time.perf_counter() - start) / 20 * 1e3
        rows[name] = dict(
            shape=list(ours.shape),
            max_abs_err=float(np.abs(ours - theirs).max()),
            max_share_of_tolerance=float((np.abs(ours - theirs) / (FLOW_ATOL + FLOW_RTOL * np.abs(theirs))).max()),
            k1_launches_per_call=launches,
            gpu_us=ms * 1e3,
            gpu_records_per_call=records,
            timer=timer,
            host_us_with_copy=host_ms * 1e3,
        )
    expected = {"log_prob_all": 4 * INS_LEVELS, "log_prob_ith": 4}
    emit("ins_flow_gpu_vs_cpu", levels=INS_LEVELS, n=len(x), atol=FLOW_ATOL, rtol=FLOW_RTOL,
         timing=("gpu_us: GPU time per call of the device work (torch.profiler, 50 calls); "
                 "host_us_with_copy: host wall per call of the numpy entry point, mean of 20"),
         **rows)
    for name, n in expected.items():
        if rows[name]["k1_launches_per_call"] != n:
            raise RuntimeError(f"{name} launched K1 {rows[name]['k1_launches_per_call']} times, not {n}")


def phase_reparam_inverse():
    """Every registered reparameterisation's ``torch_inverse`` on the GPU
    against its host ``inverse_reparameterise`` in float64, on
    ``REPARAM_ROWS`` rows of its test case after an ``update`` (live
    bounds) and a forward pass (detected edges, sampled radii)."""
    from nessai_tpu_torch.reparameterisations import default_reparameterisations, get_reparameterisation
    from nessai_tpu_torch.utils.testing import reparameterisation_case

    rows = {}
    failed = []
    for name in default_reparameterisations:
        parameters, bounds, kwargs, data = reparameterisation_case(name, REPARAM_ROWS, seed=21)
        cls, config = get_reparameterisation(name)
        config.update(kwargs)
        r = cls(parameters=parameters, prior_bounds=bounds, rng=np.random.default_rng(22), **config)
        fields = list(data) + [a for a in r.auxiliary_parameters if a not in data]
        x = np.full(REPARAM_ROWS, np.nan, dtype=[(f, "f8") for f in fields])
        for f, v in data.items():
            x[f] = v
        r.update(x)
        x_prime = np.zeros(REPARAM_ROWS, dtype=[(f, "f8") for f in r.prime_parameters])
        _, x_prime, _ = r.reparameterise(x.copy(), x_prime, np.zeros(REPARAM_ROWS))
        for f in r.prime_parameters:
            x_prime[f] = x_prime[f].astype(np.float32)
        ref = np.full(len(x_prime), np.nan, dtype=x.dtype)
        ref, _, ref_lj = r.inverse_reparameterise(ref, x_prime.copy(), np.zeros(len(x_prime)))
        cols = {f: torch.as_tensor(x_prime[f], dtype=torch.float32, device="cuda") for f in r.prime_parameters}
        updates, log_j = r.torch_inverse(cols)
        torch.cuda.synchronize()
        errs = {}
        for f, v in updates.items():
            if v.device.type != "cuda":
                raise RuntimeError(f"{name}: column {f} left the GPU")
            diff = np.abs(v.double().cpu().numpy() - ref[f])
            errs[f] = float((diff / (1.0 + np.abs(ref[f]))).max())
        lj = log_j.double().cpu().numpy() if isinstance(log_j, torch.Tensor) else np.asarray(log_j, float)
        lj_err = float((np.abs(np.broadcast_to(lj, len(ref_lj)) - ref_lj) / (1.0 + np.abs(ref_lj))).max())
        rows[str(name)] = dict(x_err=errs, log_j_err=lj_err, columns=sorted(updates))
        if max(errs.values()) > REPARAM_X_TOL or lj_err > REPARAM_LJ_TOL:
            failed.append(str(name))
    emit("reparam_inverse_gpu_vs_cpu", n=REPARAM_ROWS, x_tol=REPARAM_X_TOL, log_j_tol=REPARAM_LJ_TOL,
         error="max |gpu - host float64| / (1 + |host|)", names=len(rows), rows=rows)
    if failed:
        raise RuntimeError(f"device inverse of {failed} disagrees with the host's")


def _drive(config, counters, model=None, run_kwargs=None, before_run=None):
    """One run of ``config`` on ``model`` (``IntegrationTestModel(2)`` by
    default) through ``FlowSampler(..., device="cuda")`` and
    ``fs.run(**run_kwargs)``, with every launch counter in ``counters``
    (wrapper, attribute) set to 0 just before it and read just after;
    ``before_run(fs)`` is called between the two. Returns the sampler,
    the model, the run's output, its wall seconds and the counts."""
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as output:
        model = IntegrationTestModel(2) if model is None else model
        torch.cuda.reset_peak_memory_stats()
        for wrapper, attr in counters.values():
            setattr(wrapper, attr, 0)
        start = time.perf_counter()
        fs = FlowSampler(model, output=output, device="cuda", **config)
        if before_run is not None:
            before_run(fs)
        _, samples = fs.run(plot=False, save=False, **(run_kwargs or {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {key: int(getattr(w, a)) for key, (w, a) in counters.items()}
    return fs, model, samples, wall, launches


def _flagship_run(config, counters):
    """One standard nested-sampling run of ``config`` on the GPU (see
    :func:`_drive`). Returns the run's summary, the counts and the
    sampler."""
    fs, model, nested, wall, launches = _drive(config, counters)
    logZ = fs.logZ
    ns = fs.ns
    analytic = float(model.analytic_log_evidence)
    err = float(fs.logZ_error)
    pull = (logZ - analytic) / err
    evals = int(model.likelihood_evaluations)
    result = dict(
        logZ=logZ,
        logZ_err=err,
        logZ_err_simulated=ns.log_evidence_error_simulated,
        analytic=analytic,
        pull=pull,
        within_2sigma=bool(abs(pull) < 2.0),
        iterations=int(ns.iteration),
        likelihood_evaluations=evals,
        trainings=int(ns.train_count),
        wall_s=wall,
        sampling_time_s=ns.sampling_time.total_seconds(),
        training_time_s=ns.training_time.total_seconds(),
        training_epochs=len(ns.flow_proposal.flow.history["loss"]),
        population_time_s=ns.flow_proposal.population_time.total_seconds(),
        populates=int(ns.flow_proposal.populated_count),
        uninformed_population_time_s=ns._uninformed_proposal.population_time.total_seconds(),
        likelihood_evaluations_per_s=evals / wall,
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    return result, nested, fs


def _check_run(result, nested, fs):
    pull = result["pull"]
    if not math.isfinite(pull) or abs(pull) >= PULL_LIMIT:
        raise RuntimeError(f"logZ pull {pull} is not within {PULL_LIMIT} sigma")
    if len(nested) != fs.ns.iteration + fs.ns.nlive:
        raise RuntimeError("nested samples do not match iterations + nlive")
    post = fs.posterior_samples
    if not post.size or not all(np.isfinite(post[n]).all() for n in fs.ns.model.names):
        raise RuntimeError("posterior samples are empty or not finite")


def phase_flagship():
    from nessai_tpu_torch.ops import coupling, rqs
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    # bench.py:51-63: nlive 1000, seed 1234, RealNVP 4 x [permutation,
    # resnet affine coupling, actnorm], 100 epochs, patience 20
    result, nested, fs = _flagship_run(
        FLAGSHIP,
        {
            "k1_launches": (coupling.affine_coupling, "launches"),
            "k1_backward_launches": (coupling.affine_coupling, "backward_launches"),
            "rqs_launches": (rqs, "launches"),
            "rqs_backward_launches": (rqs, "backward_launches"),
            **_rqs_unit_counters(),
        },
    )
    emit("flagship", **result)
    if result["k1_launches"] == 0 or result["k1_backward_launches"] == 0:
        raise RuntimeError(
            "the flagship run launched the affine-coupling kernels "
            f"{result['k1_launches']} (forward/inverse) and "
            f"{result['k1_backward_launches']} (backward) times"
        )
    _check_run(result, nested, fs)
    return result


def phase_flagship_fuse_likelihood_false(flagship):
    """``FLAGSHIP`` with ``fuse_likelihood=False``: the likelihood only on
    the accepted pools. Fails unless the run gives the flagship's bits
    (the same float32 device likelihood, on fewer rows) with fewer
    likelihood evaluations and K1 launched."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    result, nested, fs = _flagship_run(dict(FLAGSHIP, fuse_likelihood=False), _k1_counters())
    result["fused_likelihood_evaluations"] = flagship["likelihood_evaluations"]
    result["same_logZ_bits_as_the_flagship"] = result["logZ"] == flagship["logZ"]
    emit("flagship_fuse_likelihood_false", **result)
    if not result["same_logZ_bits_as_the_flagship"] or result["iterations"] != flagship["iterations"]:
        raise RuntimeError(f"the split likelihood changed the flagship's run: {result['logZ']} {flagship['logZ']}")
    if not result["likelihood_evaluations"] < flagship["likelihood_evaluations"] or result["k1_launches"] == 0:
        raise RuntimeError(f"the split likelihood evaluated {result['likelihood_evaluations']} points")
    _check_run(result, nested, fs)
    return result


def phase_flagship_nsf():
    from nessai_tpu_torch.ops import coupling, rqs
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_NSF

    # the same run with the neural spline flow: 4 x [permutation, resnet
    # RQS coupling with 8 bins and linear tails on [-5, 5]], no actnorm
    result, nested, fs = _flagship_run(
        FLAGSHIP_NSF,
        {
            "rqs_launches": (rqs, "launches"),
            "rqs_backward_launches": (rqs, "backward_launches"),
            "k1_launches": (coupling.affine_coupling, "launches"),
            "k1_backward_launches": (coupling.affine_coupling, "backward_launches"),
            **_rqs_unit_counters(),
        },
    )
    emit("flagship_nsf", **result)
    if result["rqs_launches"] == 0 or result["rqs_backward_launches"] == 0:
        raise RuntimeError(
            "the NSF flagship launched the spline kernels "
            f"{result['rqs_launches']} (forward/inverse) and "
            f"{result['rqs_backward_launches']} (backward) times"
        )
    _check_run(result, nested, fs)
    return result


def _k1_counters():
    """The launch counters of every kernel, K1 first: (wrapper, attribute)
    by the name of the count."""
    from nessai_tpu_torch.ops import coupling, rqs

    return {
        "k1_launches": (coupling.affine_coupling, "launches"),
        "k1_backward_launches": (coupling.affine_coupling, "backward_launches"),
        "rqs_launches": (rqs, "launches"),
        "rqs_backward_launches": (rqs, "backward_launches"),
        **_rqs_unit_counters(),
    }


def _rqs_unit_counters():
    """The counts of K2's tails=None variant (forward and inverse, the
    inverse among them, backward)."""
    from nessai_tpu_torch.ops import rqs

    return {
        "rqs_unit_launches": (rqs, "unit_launches"),
        "rqs_unit_inverse_launches": (rqs, "unit_inverse_launches"),
        "rqs_unit_backward_launches": (rqs, "unit_backward_launches"),
    }


#: the flow constructions that the flagships do not build, each held GPU
#: vs CPU at the flagship's width (the unit-hypercube flow at its run's):
#: name, flow config, dimensions, inputs, reference dtype (float64 where a
#: spline runs: its float32 plain version strays more than the kernel,
#: which computes in double) and weight perturbation
NEW_FLOWS = (
    ("realnvp_lu", dict(n_blocks=4, n_layers=2, n_neurons=16, linear_transform="lu"), 2, "normal", torch.float32, 0.05),
    ("realnvp_svd", dict(n_blocks=4, n_neurons="auto", n_layers=2, linear_transform="svd"), 2, "normal",
     torch.float32, 0.05),
    ("maf", dict(ftype="maf", n_blocks=4, n_neurons="auto", n_layers=2), 2, "normal", torch.float32, 0.05),
    ("nsf_logit", dict(ftype="nsf", n_blocks=4, n_neurons="auto", n_layers=2, pre_transform="logit"), 2, "unit",
     torch.float64, NSF_FLOW_PERTURBATION),
    ("realnvp_lars", dict(n_blocks=4, n_neurons="auto", n_layers=2, distribution="lars"), 2, "normal",
     torch.float32, 0.05),
    ("nsf_unit_hypercube", None, 4, "unit", torch.float64, NSF_FLOW_PERTURBATION),
)


def phase_new_flows(seconds):
    """Every construction of ``NEW_FLOWS`` GPU vs CPU (``phase_flow``);
    the unit-hypercube flow is ``FLAGSHIP_INS_HYPERCUBE``'s."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_HYPERCUBE

    for name, flow_config, dims, inputs, dtype, scale in NEW_FLOWS:
        config = dict(flow_config=flow_config or FLAGSHIP_INS_HYPERCUBE["flow_config"])
        timed(seconds, f"flow_{name}", phase_flow, config, name, scale=scale, reference_dtype=dtype, dims=dims,
              inputs=inputs)


def phase_flagship_lu():
    """``FLAGSHIP_LU``, the documented flow configuration
    (``docs/normalising-flows-configuration.md:52-66``: LU linear layers)
    on the standard sampler, in full."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_LU

    result, nested, fs = _flagship_run(FLAGSHIP_LU, _k1_counters())
    emit("flagship_lu", **result)
    if result["k1_launches"] == 0 or result["k1_backward_launches"] == 0:
        raise RuntimeError(f"the LU run launched K1 {result['k1_launches']} / {result['k1_backward_launches']} times")
    _check_run(result, nested, fs)
    return result


def phase_flagship_ins_hypercube():
    """``FLAGSHIP_INS_HYPERCUBE``, the example
    ``examples/importance_nested_sampler/nsf_unit_hypercube.py`` as
    written (nlive 10,000, the 4-D Rosenbrock likelihood, a neural spline
    flow with tails=None on a uniform base), in full. Fails unless
    |pull| < 3 against the quadrature's log-evidence with the sampler's
    own error, the samples lie in [-5, 5]^4, and K2's tails=None variant
    launched forward, inverse and backward."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_HYPERCUBE, phase_times
    from nessai_tpu_torch.utils.testing import RosenbrockModel, rosenbrock_log_evidence

    # the transfer-matrix quadrature: -15.1016907 at 4001, 8001 and 16001 points
    analytic = rosenbrock_log_evidence(4, n=8001)
    fs, model, samples, wall, launches = _drive(FLAGSHIP_INS_HYPERCUBE, _k1_counters(), model=RosenbrockModel(4))
    ns = fs.ns
    err = float(fs.logZ_error)
    pull = (fs.logZ - analytic) / err
    times = phase_times(fs)
    result = dict(
        levels=times.pop("levels"),
        logZ=fs.logZ,
        logZ_err=err,
        analytic=analytic,
        pull=pull,
        samples=int(len(samples)),
        final_ess=float(ns.state.effective_n_posterior_samples),
        likelihood_evaluations=int(model.likelihood_evaluations),
        wall_s=wall,
        sampling_time_s=ns.sampling_time.total_seconds(),
        **times,
        training_share_of_wall=times["training_time_s"] / wall,
        rqs_unit_forward_launches=launches["rqs_unit_launches"] - launches["rqs_unit_inverse_launches"],
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    emit("flagship_ins_hypercube", **result)
    checks = {
        "|pull| < 3": math.isfinite(pull) and abs(pull) < PULL_LIMIT,
        "nested samples in [-5, 5]^4": _in_bounds(samples, model),
        "posterior samples in [-5, 5]^4": _in_bounds(fs.posterior_samples, model),
        "tails=None forward launched": result["rqs_unit_forward_launches"] > 0,
        "tails=None inverse launched": launches["rqs_unit_inverse_launches"] > 0,
        "tails=None backward launched": launches["rqs_unit_backward_launches"] > 0,
    }
    if not all(checks.values()):
        raise RuntimeError(f"flagship_ins_hypercube: failed {[k for k, v in checks.items() if not v]}")
    return result


def phase_flagship_ins():
    """The importance nested sampler's flagship (``FLAGSHIP_INS``) in
    full on the GPU."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS, phase_times

    fs, model, samples, wall, launches = _drive(FLAGSHIP_INS, _k1_counters())
    ns = fs.ns
    analytic = float(model.analytic_log_evidence)
    err = float(fs.logZ_error)
    pull = (fs.logZ - analytic) / err
    evals = int(model.likelihood_evaluations)
    result = dict(
        logZ=fs.logZ,
        logZ_err=err,
        analytic=analytic,
        pull=pull,
        within_2sigma=bool(abs(pull) < 2.0),
        iterations=int(ns.iteration),
        samples=int(len(samples)),
        training_samples=int(len(ns.training_samples.samples)),
        final_ess=float(ns.state.effective_n_posterior_samples),
        likelihood_evaluations=evals,
        wall_s=wall,
        sampling_time_s=ns.sampling_time.total_seconds(),
        **phase_times(fs),
        add_and_update_time_s=ns.add_and_update_samples_time.total_seconds(),
        likelihood_evaluations_per_s=evals / wall,
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    emit("flagship_ins", **result)
    if launches["k1_launches"] == 0 or launches["k1_backward_launches"] == 0:
        raise RuntimeError(
            "the INS flagship launched the affine-coupling kernels "
            f"{launches['k1_launches']} (forward/inverse) and "
            f"{launches['k1_backward_launches']} (backward) times"
        )
    if not math.isfinite(pull) or abs(pull) >= PULL_LIMIT:
        raise RuntimeError(f"INS logZ pull {pull} is not within {PULL_LIMIT} sigma")
    # the initial prior draws and nlive more at every level
    if result["levels"] != ns.iteration or len(samples) != (ns.iteration + 1) * ns.nlive:
        raise RuntimeError("INS levels or samples do not match the iterations")
    post = fs.posterior_samples
    if not post.size or not all(np.isfinite(post[n]).all() for n in model.names):
        raise RuntimeError("INS posterior samples are empty or not finite")
    return result


def _in_bounds(samples, model):
    return bool(
        len(samples)
        and all(
            np.isfinite(samples[n]).all()
            and ((samples[n] >= model.bounds[n][0]) & (samples[n] <= model.bounds[n][1])).all()
            for n in model.names
        )
    )


class _Messages(logging.Handler):
    """Keeps the messages of the records it sees."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_flagship_ins_mixture():
    """The Gaussian-mixture configuration of the importance nested sampler
    (``FLAGSHIP_INS_MIXTURE``: nlive 2000, ratio and ESS criteria, then
    the final redraw to a posterior ESS of 2000) in full on the GPU."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_MIXTURE, FLAGSHIP_INS_MIXTURE_RUN, phase_times
    from nessai_tpu_torch.utils.stats import effective_sample_size
    from nessai_tpu_torch.utils.testing import GaussianMixture

    n_post = FLAGSHIP_INS_MIXTURE_RUN["n_posterior_samples"]
    sampler_log = logging.getLogger("nessai_tpu_torch.samplers.importancesampler")
    messages = _Messages()
    sampler_log.addHandler(messages)
    try:
        fs, model, samples, wall, launches = _drive(
            FLAGSHIP_INS_MIXTURE, _k1_counters(), model=GaussianMixture(2), run_kwargs=FLAGSHIP_INS_MIXTURE_RUN
        )
    finally:
        sampler_log.removeHandler(messages)
    ns = fs.ns
    analytic = float(model.analytic_log_evidence)
    stopped_at_ratio = any("maximum number of redraw samples" in m for m in messages.messages)
    redraw_ess = float(effective_sample_size(ns.final_log_w))
    times = phase_times(fs)
    result = dict(
        levels=times.pop("levels"),
        samples=int(len(samples)),
        sampler_logZ=fs.initial_logZ,
        sampler_logZ_err=fs.initial_logZ_error,
        sampler_pull=(fs.initial_logZ - analytic) / fs.initial_logZ_error,
        sampler_ess=float(ns.state.effective_n_posterior_samples),
        logZ=fs.logZ,
        logZ_err=fs.logZ_error,
        analytic=analytic,
        pull=(fs.logZ - analytic) / fs.logZ_error,
        redraw_samples=int(len(ns.final_samples_unit)),
        redraw_ess=redraw_ess,
        redraw_stopped_at_max_samples_ratio=stopped_at_ratio,
        wall_s=wall,
        sampling_time_s=ns.sampling_time.total_seconds(),
        **times,
        likelihood_time_s=model.likelihood_evaluation_time.total_seconds(),
        likelihood_evaluations=int(model.likelihood_evaluations),
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    emit("flagship_ins_mixture", **result)
    if launches["k1_launches"] == 0 or launches["k1_backward_launches"] == 0:
        raise RuntimeError(
            "the mixture run launched the affine-coupling kernels "
            f"{launches['k1_launches']} (forward/inverse) and "
            f"{launches['k1_backward_launches']} (backward) times"
        )
    for name in ("sampler_pull", "pull"):
        if not math.isfinite(result[name]) or abs(result[name]) >= PULL_LIMIT:
            raise RuntimeError(f"mixture {name} {result[name]} is not within {PULL_LIMIT} sigma")
    if not _in_bounds(samples, model):
        raise RuntimeError("the mixture run's nested samples are not inside the prior bounds")
    if not _in_bounds(fs.posterior_samples, model):
        raise RuntimeError("the mixture run's posterior samples are empty, not finite or out of bounds")
    if redraw_ess < n_post:
        if not stopped_at_ratio:
            raise RuntimeError(f"the redraw's ESS {redraw_ess} is below {n_post} without the max_samples_ratio stop")
        print(f"the redraw stopped at max_samples_ratio with an ESS of {redraw_ess} < {n_post}", flush=True)
    return result


def phase_flagship_reparam(name, config, model):
    """A run of the standard sampler through the reparameterisations
    (``config`` on ``model``, both from the JAX package's examples) in
    full on the GPU. Fails unless |pull| < 3, K1 forward and backward
    launched, and the nested and posterior samples lie in the model's
    bounds. Records the edges each training detected."""
    edges = []

    def record_edges(fs):
        proposal = fs.ns.flow_proposal
        train = proposal.train

        def recording(x, **kwargs):
            train(x, **kwargs)
            edges.append({k: dict(r._edges) for k, r in proposal._reparameterisation.items()
                          if getattr(r, "_edges", None)})

        proposal.train = recording

    fs, model, nested, wall, launches = _drive(config, _k1_counters(), model=model, before_run=record_edges)
    ns = fs.ns
    proposal = ns.flow_proposal
    analytic = float(model.analytic_log_evidence)
    err = float(fs.logZ_error)
    pull = (fs.logZ - analytic) / err
    training = ns.training_time.total_seconds()
    result = dict(
        logZ=fs.logZ,
        logZ_err=err,
        analytic=analytic,
        pull=pull,
        iterations=int(ns.iteration),
        trainings=int(ns.train_count),
        wall_s=wall,
        sampling_time_s=ns.sampling_time.total_seconds(),
        training_time_s=training,
        training_share_of_wall=training / wall,
        training_epochs=len(proposal.flow.history["loss"]),
        population_time_s=proposal.population_time.total_seconds(),
        populates=int(proposal.populated_count),
        likelihood_evaluations=int(model.likelihood_evaluations),
        likelihood_time_s=model.likelihood_evaluation_time.total_seconds(),
        parameters=list(proposal.parameters),
        prime_parameters=list(proposal.prime_parameters),
        reparameterisations={k: type(r).__name__ for k, r in proposal._reparameterisation.items()},
        edges_by_training=edges,
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    emit(name, **result)
    if launches["k1_launches"] == 0 or launches["k1_backward_launches"] == 0:
        raise RuntimeError(f"{name} launched K1 {launches}")
    if not math.isfinite(pull) or abs(pull) >= PULL_LIMIT:
        raise RuntimeError(f"{name} logZ pull {pull} is not within {PULL_LIMIT} sigma")
    if len(nested) != ns.iteration + ns.nlive:
        raise RuntimeError(f"{name}: nested samples do not match iterations + nlive")
    if not _in_bounds(nested, model) or not _in_bounds(fs.posterior_samples, model):
        raise RuntimeError(f"{name}: samples are empty, not finite or outside the prior bounds")
    return result, edges, fs


def phase_flagship_reparam_inversion():
    """``FLAGSHIP_REPARAM_INVERSION`` (``examples/half_gaussian.py``):
    also fails unless a training detected an edge for x."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_REPARAM_INVERSION
    from nessai_tpu_torch.utils.testing import HalfGaussianModel

    result, edges, _ = phase_flagship_reparam(
        "flagship_reparam_inversion", FLAGSHIP_REPARAM_INVERSION, HalfGaussianModel()
    )
    if not any(e.get("rescaletobounds_x", {}).get("x") for e in edges):
        raise RuntimeError(f"the inversion run detected no edge for x: {edges}")
    return result


def phase_flagship_reparam_angle():
    """``FLAGSHIP_REPARAM_ANGLE`` (``examples/reparameterisations_example.py``):
    also fails unless theta lies in [0, 2 pi] and the auxiliary radius
    is a column of the x space, not of the returned samples."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_REPARAM_ANGLE
    from nessai_tpu_torch.utils.testing import AngleModel

    result, _, fs = phase_flagship_reparam("flagship_reparam_angle", FLAGSHIP_REPARAM_ANGLE, AngleModel())
    theta = np.concatenate([fs.nested_samples["theta"], fs.posterior_samples["theta"]])
    if not (np.all(theta >= 0.0) and np.all(theta <= 2 * np.pi)):
        raise RuntimeError("the angle run's theta leaves [0, 2 pi]")
    if result["prime_parameters"] != ["theta_x", "theta_y", "amp_prime"] or "theta_radial" not in result["parameters"]:
        raise RuntimeError(f"unexpected spaces: {result['parameters']}, {result['prime_parameters']}")
    if "theta_radial" in fs.nested_samples.dtype.names:
        raise RuntimeError("the auxiliary radius reached the returned samples")
    return result


def _standard_result(fs, model, wall, launches, analytic):
    """The summary of a standard-sampler run: logZ and its pull against
    ``analytic`` (None where the run was capped), iterations, trainings,
    times, likelihood evaluations and the kernel launches."""
    ns = fs.ns
    proposal = ns.flow_proposal
    err = float(fs.logZ_error)
    training = ns.training_time.total_seconds()
    return dict(
        logZ=fs.logZ,
        logZ_err=err,
        logZ_err_simulated=ns.log_evidence_error_simulated,
        analytic=analytic,
        pull=None if analytic is None else (fs.logZ - analytic) / err,
        iterations=int(ns.iteration),
        trainings=int(ns.train_count),
        wall_s=wall,
        training_time_s=training,
        training_share_of_wall=training / wall,
        training_epochs=len(proposal.flow.history["loss"]),
        population_time_s=proposal.population_time.total_seconds(),
        populates=int(proposal.populated_count),
        population_acceptance=proposal.population_acceptance,
        acceptance=ns.acceptance,
        likelihood_evaluations=int(model.likelihood_evaluations),
        likelihood_time_s=model.likelihood_evaluation_time.total_seconds(),
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )


def _check_standard(name, result, nested, fs, model, kernels=("k1_launches", "k1_backward_launches")):
    """Fails unless the run launched ``kernels``, its nested and posterior
    samples lie in the prior bounds and, where it ran to its end, |pull|
    < 3."""
    if any(result[k] == 0 for k in kernels):
        raise RuntimeError(f"{name} launched {({k: result[k] for k in kernels})}")
    if result["pull"] is not None and (not math.isfinite(result["pull"]) or abs(result["pull"]) >= PULL_LIMIT):
        raise RuntimeError(f"{name} logZ pull {result['pull']} is not within {PULL_LIMIT} sigma")
    if len(nested) != fs.ns.iteration + fs.ns.nlive:
        raise RuntimeError(f"{name}: nested samples do not match iterations + nlive")
    if not _in_bounds(nested, model) or not _in_bounds(fs.posterior_samples, model):
        raise RuntimeError(f"{name}: samples are empty, not finite or outside the prior bounds")


#: a posterior sample belongs to an egg-box mode within this distance of
#: its peak (the peaks are 0.1 wide and 2 pi apart)
EGGBOX_MODE_RADIUS = 1.0
#: The egg-box example in full takes about 40 minutes on the H100 (its
#: last 5,000 of about 19,000 iterations retrain the flow every few
#: iterations, each training an eager step of 10-20 ms an epoch; PERF.md),
#: past this script's time limit. Here it stops at this iteration (dlogZ
#: about 4, some 110 s); ``python3 chip_smoke.py --eggbox-in-full`` runs
#: it to its end with the same checks and the pull's gate.
EGGBOX_SMOKE_ITERATIONS = 12_000


def phase_flagship_eggbox(max_iteration=EGGBOX_SMOKE_ITERATIONS):
    """``FLAGSHIP_EGGBOX``, ``examples/eggbox.py`` as written (nlive 2000,
    seed 170817, ``reset_flow=8``), to ``max_iteration`` (None: to its
    end). Fails unless the flow was reset (weights and permutations)
    before every 8th training and at no other, K1 launched forward and
    backward, each of the 18 modes holds posterior samples
    (``every_mode_holds_posterior_samples``) and, where the run ended by
    itself, |pull| < 3 against the quadrature's log-evidence."""
    from scipy.spatial.distance import cdist

    from nessai_tpu_torch.flowmodel import FlowModel
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_EGGBOX
    from nessai_tpu_torch.utils.testing import EggboxModel, eggbox_log_evidence

    resets, sampler = [], []
    real = FlowModel.reset_model

    def recording(self, weights=True, permutations=False):
        resets.append(dict(before_training=sampler[0].train_count + 1, weights=weights, permutations=permutations))
        return real(self, weights=weights, permutations=permutations)

    FlowModel.reset_model = recording
    try:
        fs, model, nested, wall, launches = _drive(
            dict(FLAGSHIP_EGGBOX, max_iteration=max_iteration), _k1_counters(), model=EggboxModel(2),
            before_run=lambda fs: sampler.append(fs.ns),
        )
    finally:
        FlowModel.reset_model = real
    analytic = eggbox_log_evidence()
    result = _standard_result(fs, model, wall, launches, analytic)
    if max_iteration is not None and fs.ns.iteration >= max_iteration:
        # a pull is reported, not gated, where the run was stopped
        result["pull_of_the_stopped_run"] = result.pop("pull")
        result["pull"] = None
    post = fs.posterior_samples
    xy = np.stack([post["x_0"], post["x_1"]], axis=1)
    d = cdist(xy, model.modes())
    near = d.min(axis=1) < EGGBOX_MODE_RADIUS
    counts = np.bincount(d.argmin(axis=1)[near], minlength=len(model.modes()))
    expected_resets = list(range(9, result["trainings"] + 1, 8))
    result.update(
        max_iteration=max_iteration,
        dlogZ_at_the_end_of_the_loop=fs.ns.history["dlogZ"][-1] if fs.ns.history["dlogZ"] else None,
        analytic_from="utils.testing.eggbox_log_evidence (4001-point trapezoid quadrature)",
        resets=resets,
        expected_reset_before_trainings=expected_resets,
        posterior_samples_by_mode=counts.tolist(),
        posterior_samples_near_no_mode=int((~near).sum()),
        every_mode_holds_posterior_samples=bool((counts > 0).all()),
    )
    emit("flagship_eggbox", **result)
    _check_standard("flagship_eggbox", result, nested, fs, model)
    if [r["before_training"] for r in resets] != expected_resets or not all(
        r["weights"] and r["permutations"] for r in resets
    ):
        raise RuntimeError(f"the egg-box run's resets {resets} are not a full reset at every 8th training")
    if not result["every_mode_holds_posterior_samples"]:
        raise RuntimeError(f"an egg-box mode holds no posterior sample: {counts.tolist()}")
    return result


def phase_flagship_augmented():
    """``FLAGSHIP_AUGMENTED``, ``examples/augmented_example.py`` as written
    (the augmented flow proposal with two augment dimensions, nlive
    2000), in full. Fails unless |pull| < 3 against -log 400, K1 launched
    forward and backward (a 4-D flow with the fixed mask), the flow saw
    the augment columns and the returned samples do not hold them."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_AUGMENTED
    from nessai_tpu_torch.utils.testing import BimodalGaussianModel

    model = BimodalGaussianModel()
    fs, model, nested, wall, launches = _drive(FLAGSHIP_AUGMENTED, _k1_counters(), model=model)
    result = _standard_result(fs, model, wall, launches, float(model.analytic_log_evidence))
    proposal = fs.ns.flow_proposal
    dropped = not any(
        n.startswith("e_") for n in (*fs.posterior_samples.dtype.names, *nested.dtype.names)
    )
    result.update(
        proposal=type(proposal).__name__,
        prime_parameters=list(proposal.prime_parameters),
        mask=np.asarray(proposal.flow.flow_config.kwargs.get("mask")).tolist(),
        augment_columns_dropped=dropped,
        modes=[int((fs.posterior_samples["x"] < 0).sum()), int((fs.posterior_samples["x"] > 0).sum())],
    )
    emit("flagship_augmented", **result)
    _check_standard("flagship_augmented", result, nested, fs, model)
    if result["prime_parameters"][-2:] != ["e_0", "e_1"] or not dropped:
        raise RuntimeError(f"augment columns: flow saw {result['prime_parameters']}, dropped {dropped}")
    if min(result["modes"]) == 0:
        raise RuntimeError(f"a mode of the bimodal posterior holds no sample: {result['modes']}")
    return result


#: short runs of the standard sampler's options on ``IntegrationTestModel(2)``
#: at nlive 500 (seed 1234): name, options and the kernels the run must
#: launch; each also has its own check in ``phase_standard_options``
#: (options that do not interact share a run, for the time limit)
STANDARD_OPTIONS_BASE = dict(nlive=500, seed=1234, resume=False, plot=False, checkpointing=False)
K1_RUN = ("k1_launches", "k1_backward_launches")
STANDARD_OPTION_RUNS = (
    ("default", {}, K1_RUN),
    ("adaptive_radius", dict(constant_volume_mode=False), K1_RUN),
    ("fixed_radius", dict(fixed_radius=2.5), K1_RUN),
    ("truncation_rules", dict(truncation=["latent_radius", "min_log_q", "likelihood_threshold"]), K1_RUN),
    ("fuse_likelihood_false", dict(fuse_likelihood=False), K1_RUN),
    ("max_iteration", dict(max_iteration=2000), K1_RUN),
    ("training_frequency", dict(training_frequency=500, cooldown=100, train_on_empty=False), K1_RUN),
    ("reset_acceptance_shrinkage_t", dict(reset_acceptance=True, shrinkage_expectation="t"), K1_RUN),
    ("analytic_priors_batch_size_all", dict(analytic_priors=True, training_config=dict(batch_size="all")), K1_RUN),
    ("adam_annealing", dict(training_config=dict(optimiser="adam", annealing=True)), K1_RUN),
    ("sgd_noise_constant", dict(training_config=dict(optimiser="sgd", optimiser_kwargs=dict(momentum=0.9),
                                                     noise_type="constant", noise_scale=0.01)), K1_RUN),
    ("marginalise_augment", dict(flow_class="augmentedflowproposal", augment_dims=2, marginalise_augment=True),
     K1_RUN),
    ("nsf_unit_hypercube", dict(map_to_unit_hypercube=True, flow_config=dict(ftype="nsf")),
     ("rqs_launches", "rqs_backward_launches")),
)


def _option_check(name, fs, result, results):
    """Each option run's own check: the option is held and did what it
    says. Returns the facts checked."""
    ns = fs.ns
    proposal = ns.flow_proposal
    flow = proposal.flow
    if name == "adaptive_radius":
        rule = proposal.get_truncation_rule("latent_radius")
        facts = dict(mode=rule.mode, last_radius=rule.r, fuzz=rule.fuzz)
        ok = rule.mode == "adaptive" and math.isfinite(rule.r) and rule.fuzz > 1.0
    elif name == "fixed_radius":
        facts = dict(last_radius=proposal.r)
        ok = proposal.r == 2.5
    elif name == "truncation_rules":
        facts = dict(rules=proposal.truncation_methods, fused=proposal._fuse_likelihood_resolved)
        ok = facts["rules"] == ["latent_radius", "min_log_q", "likelihood_threshold"] and facts["fused"]
    elif name == "fuse_likelihood_false":
        fused = results["default"]
        facts = dict(
            likelihood_evaluations=result["likelihood_evaluations"],
            fused_likelihood_evaluations=fused["likelihood_evaluations"],
            fused_iterations=fused["iterations"],
        )
        ok = result["likelihood_evaluations"] < fused["likelihood_evaluations"]
    elif name == "max_iteration":
        facts = dict(iteration=int(ns.iteration))
        ok = ns.iteration == 2000
    elif name == "training_frequency":
        gaps = np.diff(ns.training_iterations).tolist()
        facts = dict(training_iterations=list(ns.training_iterations))
        ok = all(g >= 100 for g in gaps)
    elif name == "reset_acceptance_shrinkage_t":
        facts = dict(reset_acceptance=ns.reset_acceptance, expectation=ns.state.expectation,
                     logZ_logt=results["default"]["logZ"])
        ok = ns.reset_acceptance is True and ns.state.expectation == "t"
    elif name == "analytic_priors_batch_size_all":
        facts = dict(uninformed_proposal=type(ns._uninformed_proposal).__name__,
                     batch_size=flow.training_config.batch_size)
        ok = facts["uninformed_proposal"] == "AnalyticProposal" and facts["batch_size"] == "all"
    elif name == "adam_annealing":
        facts = dict(optimiser=type(flow.optimiser).__name__, last_lr=flow.optimiser.param_groups[0]["lr"],
                     lr=flow.training_config.lr)
        ok = facts["optimiser"] == "Adam" and facts["last_lr"] < facts["lr"]
    elif name == "sgd_noise_constant":
        facts = dict(optimiser=type(flow.optimiser).__name__, noise_generator=flow._device_generator is not None)
        ok = facts["optimiser"] == "SGD" and facts["noise_generator"]
    elif name == "marginalise_augment":
        facts = dict(prime_parameters=list(proposal.prime_parameters), n_marg=proposal.n_marg)
        ok = proposal.marginalise_augment and facts["prime_parameters"][-2:] == ["e_0", "e_1"]
    elif name == "nsf_unit_hypercube":
        facts = dict(map_to_unit_hypercube=proposal.map_to_unit_hypercube, k1_launches=result["k1_launches"])
        ok = proposal.map_to_unit_hypercube and result["k1_launches"] == 0
    else:
        facts, ok = {}, True
    return facts, ok


def phase_standard_options():
    """``STANDARD_OPTION_RUNS``: short runs of the standard sampler's
    options (truncation rules, the likelihood split, the iteration cap,
    the training schedule, the uninformed proposal, the shrinkage, the
    optimisers and training options, the augmented marginal, the unit
    hypercube with the spline flow) on the GPU, each with its kernels,
    its own check and, where it ran to its end, |pull| < 3."""
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    results = {}
    for name, options, kernels in STANDARD_OPTION_RUNS:
        model = IntegrationTestModel(2)
        fs, model, nested, wall, launches = _drive(dict(STANDARD_OPTIONS_BASE, **options), _k1_counters(),
                                                   model=model)
        capped = "max_iteration" in options
        result = _standard_result(fs, model, wall, launches, None if capped else float(model.analytic_log_evidence))
        facts, ok = _option_check(name, fs, result, results)
        result.update(options=repr(options), **facts)
        emit(f"standard_options_{name}", **result)
        _check_standard(name, result, nested, fs, model, kernels=kernels)
        if not ok:
            raise RuntimeError(f"standard_options_{name}: its check failed: {facts}")
        results[name] = result
    return {f"standard_options_{name}": r for name, r in results.items()}


#: the capped option runs of ``ins_options``: name and sampler options
INS_OPTION_RUNS = (
    ("ins_weighted_kl_bootstrap", dict(weighted_kl=True, bootstrap=True)),
    ("ins_replace_all_final_flow", dict(replace_all=True, train_final_flow=True)),
)
INS_OPTION_LEVELS = 3


def phase_ins_options():
    """Capped runs of ``FLAGSHIP_INS`` (``INS_OPTION_LEVELS`` levels) with
    the options of the weighted flow training, the bootstrap, replace_all
    and the final flow."""
    from scipy.special import logsumexp

    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS

    results = {}
    for name, options in INS_OPTION_RUNS:
        calls = []

        def record_training(fs):
            flow = fs.ns.proposal.flow
            train = flow.train

            def recording(samples, weights=None, **kwargs):
                calls.append(None if weights is None else np.array(weights))
                return train(samples, weights=weights, **kwargs)

            flow.train = recording

        config = dict(FLAGSHIP_INS, max_iteration=INS_OPTION_LEVELS, **options)
        fs, model, samples, wall, launches = _drive(config, _k1_counters(), before_run=record_training)
        ns = fs.ns
        weights = ns.proposal.weights_array
        unset = np.isnan(weights)
        result = dict(
            options=options,
            iterations=int(ns.iteration),
            levels=int(ns.proposal.flow.n_models),
            logZ=fs.logZ,
            logZ_err=fs.logZ_error,
            weights_sum=float(weights[~unset].sum()),
            unset_weights=int(unset.sum()),
            weighted_trainings=sum(w is not None for w in calls),
            bootstrap_logZ=ns.bootstrap_log_evidence,
            bootstrap_logZ_err=ns.bootstrap_log_evidence_error,
            wall_s=wall,
            **launches,
        )
        final_flow = options.get("train_final_flow", False)
        if final_flow:
            s = ns.samples_unit
            log_w = s["logL"] + s["logW"]
            expected = np.exp(log_w - logsumexp(log_w))
            last = calls[-1]
            result["final_flow_weights_max_abs_err"] = (
                None if last is None or len(last) != len(expected) else float(np.abs(last - expected).max())
            )
        emit(name, **result)
        if not math.isfinite(fs.logZ) or not np.isclose(result["weights_sum"], 1.0):
            raise RuntimeError(f"{name}: logZ {fs.logZ}, weights summing to {result['weights_sum']}")
        if launches["k1_launches"] == 0 or launches["k1_backward_launches"] == 0:
            raise RuntimeError(f"{name}: K1 launched {launches}")
        if result["weighted_trainings"] != len(calls):
            raise RuntimeError(f"{name}: {len(calls) - result['weighted_trainings']} levels trained without weights")
        if options.get("bootstrap") and not (
            result["bootstrap_logZ_err"] is not None and math.isfinite(result["bootstrap_logZ_err"])
        ):
            raise RuntimeError(f"{name}: the bootstrap error is {result['bootstrap_logZ_err']}")
        if final_flow and not (
            result["levels"] == ns.iteration + 1
            and result["unset_weights"] == 1
            and unset[-1]
            and result["final_flow_weights_max_abs_err"] is not None
            and result["final_flow_weights_max_abs_err"] <= 1e-12
        ):
            raise RuntimeError(f"{name}: no final level trained on the posterior weights: {result}")
        results[name] = result
    return results


# ----------------------------------------------------------------------
# Checkpoint, resume, result files and the likelihood pool
# ----------------------------------------------------------------------
#: seconds a child of the resume phases may take
CHILD_TIMEOUT_S = 300
#: K1 forward through the reloaded INS levels against the log_q recorded
#: before the checkpoint; logZ as the JAX package's resume test asks;
#: the flow on the CPU against the card
RESUME_LOG_Q_TOL, RESUME_LOGZ_TOL, CPU_LOG_PROB_TOL = 1e-5, 1e-8, 1e-5


def _gpu_settings():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _has_plotting():
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _timed_dumps():
    """Time every checkpoint the samplers write (seconds per dump)."""
    from nessai_tpu_torch.samplers import base

    seconds = []
    dump = base.safe_file_dump

    def timed_dump(*args, **kwargs):
        start = time.perf_counter()
        dump(*args, **kwargs)
        seconds.append(time.perf_counter() - start)

    base.safe_file_dump = timed_dump
    return seconds


def _child_result(**fields):
    print(json.dumps({"child_result": fields}), flush=True)


def child_standard_first(output):
    """``FLAGSHIP`` with a checkpoint after every training, until the
    parent's SIGTERM."""
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.profiling import FLAGSHIP
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    _gpu_settings()
    config = dict(FLAGSHIP, resume=True, checkpointing=True, checkpoint_on_training=True)
    fs = FlowSampler(IntegrationTestModel(2), output=output, device="cuda", **config)
    fs.run(plot=False, save=False)
    _child_result(finished=True)


def child_standard_resume(output):
    """Resume ``FLAGSHIP`` from ``output`` and finish it, with the JSON
    result file."""
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.profiling import FLAGSHIP
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    _gpu_settings()
    counters = _k1_counters()
    dumps = _timed_dumps()
    model = IntegrationTestModel(2)
    config = dict(FLAGSHIP, resume=True, checkpointing=True, checkpoint_on_training=True)
    fs = FlowSampler(model, output=output, device="cuda", result_extension="json", **config)
    ns = fs.ns
    flow = ns.flow_proposal.flow
    saved = torch.load(flow.weights_file, map_location="cpu", weights_only=True)
    weights_bitwise = all(
        torch.equal(v.cpu(), saved[k]) for k, v in flow.flow.state_dict().items()
    ) and set(saved) == set(flow.flow.state_dict())
    at_resume = dict(iteration=int(ns.iteration), likelihood_evaluations=int(model.likelihood_evaluations))
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    start = time.perf_counter()
    fs.run(plot=_has_plotting(), save=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {key: int(getattr(w, a)) for key, (w, a) in counters.items()}
    with open(os.path.join(output, "result.json")) as f:
        result_file = json.load(f)
    analytic = float(model.analytic_log_evidence)
    _child_result(
        at_resume=at_resume,
        weights_bitwise=bool(weights_bitwise),
        weights_file=os.path.relpath(flow.weights_file, output),
        logZ=fs.logZ,
        logZ_err=fs.logZ_error,
        pull=(fs.logZ - analytic) / fs.logZ_error,
        iterations=int(ns.iteration),
        trainings_after_resume=int(ns.train_count),
        likelihood_evaluations=int(model.likelihood_evaluations),
        wall_s=wall,
        checkpoint_s=dumps,
        checkpoint_bytes=os.path.getsize(ns.resume_file),
        result_json_log_evidence=result_file["log_evidence"],
        result_json_posterior_samples=len(result_file["posterior_samples"][model.names[0]]),
        posterior_samples=int(fs.posterior_samples.size),
        plots=sorted(f for f in os.listdir(output) if f.endswith(".png")),
        **launches,
    )


def child_ins_first(output):
    """``FLAGSHIP_INS`` to the end of its third level, checkpointed
    there; the level's log_q matrices and logZ go to ``level3.npz``."""
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.samplers.base import safe_file_dump
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    _gpu_settings()
    dumps = []

    def at_level_end(sampler):
        # the forced checkpoint of the finished run is not kept
        if sampler.finalised:
            return
        start = time.perf_counter()
        safe_file_dump(sampler, sampler.resume_file)
        dumps.append(time.perf_counter() - start)
        np.savez(
            os.path.join(output, "level3.npz"),
            training_log_q=sampler.training_samples.log_q,
            iid_log_q=sampler.iid_samples.log_q,
            logZ=sampler.log_evidence,
            iteration=sampler.iteration,
        )

    config = dict(
        FLAGSHIP_INS,
        resume=True,
        checkpointing=True,
        max_iteration=3,
        checkpoint_on_iteration=True,
        checkpoint_interval=3,
        checkpoint_callback=at_level_end,
    )
    fs = FlowSampler(IntegrationTestModel(2), output=output, device="cuda", **config)
    fs.run(plot=False, save=False)
    _child_result(checkpoint_s=dumps, checkpoint_bytes=os.path.getsize(fs.ns.resume_file))


def child_ins_resume(output):
    """Resume ``FLAGSHIP_INS`` from its third level, hold the recomputed
    log_q and logZ against the recorded ones, and finish the run."""
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    _gpu_settings()
    counters = _k1_counters()
    model = IntegrationTestModel(2)
    fs = FlowSampler(model, output=output, device="cuda", **dict(FLAGSHIP_INS, resume=True, checkpointing=True))
    ns = fs.ns
    recorded = np.load(os.path.join(output, "level3.npz"))
    log_q_err = max(
        float(np.abs(ns.training_samples.log_q - recorded["training_log_q"]).max()),
        float(np.abs(ns.iid_samples.log_q - recorded["iid_log_q"]).max()),
    )
    logZ_at_resume = ns.log_evidence
    iteration_at_resume = int(ns.iteration)
    ns.configure_iterations(max_iteration=None)
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    start = time.perf_counter()
    fs.run(plot=False, save=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    analytic = float(model.analytic_log_evidence)
    _child_result(
        iteration_at_resume=iteration_at_resume,
        recorded_iteration=int(recorded["iteration"]),
        log_q_max_abs_err=log_q_err,
        logZ_at_resume=logZ_at_resume,
        recorded_logZ=float(recorded["logZ"]),
        logZ=fs.logZ,
        logZ_err=fs.logZ_error,
        pull=(fs.logZ - analytic) / fs.logZ_error,
        iterations=int(ns.iteration),
        wall_s=wall,
        **{key: int(getattr(w, a)) for key, (w, a) in counters.items()},
    )


CHILDREN = {
    "standard_first": child_standard_first,
    "standard_resume": child_standard_resume,
    "ins_first": child_ins_first,
    "ins_resume": child_ins_resume,
}


def _run_child(name, output, until=None):
    """Run ``chip_smoke.py --child name output`` in a new process, with
    its output in ``output``. With ``until`` (a function of the output
    directory) the child gets SIGTERM once ``until`` holds. Returns its
    exit code, its result and its wall seconds."""
    log = os.path.join(output, f"{name}.log")
    start = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", name, output],
            stdout=out,
            stderr=subprocess.STDOUT,
        )
        try:
            if until is not None:
                while proc.poll() is None and not until(output):
                    if time.perf_counter() - start > CHILD_TIMEOUT_S:
                        raise RuntimeError(f"{name}: no second checkpoint in {CHILD_TIMEOUT_S} s")
                    time.sleep(0.05)
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=CHILD_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - start
    with open(log) as f:
        lines = f.read().splitlines()
    result = None
    for line in lines:
        if line.startswith('{"child_result"'):
            result = json.loads(line)["child_result"]
    if rc not in (0, 130) or (rc == 0 and result is None):
        print("\n".join(lines[-40:]), flush=True)
    return rc, result, wall


def _second_checkpoint(output):
    resume = os.path.join(output, "nested_sampler_resume.pkl")
    return os.path.exists(resume + ".old") and os.path.exists(resume) and not os.path.exists(resume + ".temp")


def _same_bits(a, b) -> bool:
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def phase_resume_standard(output):
    """``FLAGSHIP`` in a child, checkpointed after every training, ended
    by SIGTERM after its second checkpoint (exit code 130 and a resume
    file that loads), then resumed and finished in a second child, with
    its JSON result file."""
    import pickle
    import shutil

    rc, _, first_wall = _run_child("standard_first", output, until=_second_checkpoint)
    resume_file = os.path.join(output, "nested_sampler_resume.pkl")
    with open(resume_file, "rb") as f:
        pickled = pickle.load(f)
    # kept for resume_on_cpu: this checkpoint and its weights file
    shutil.copy(resume_file, os.path.join(output, "sigterm.pkl"))
    shutil.copy(pickled._flow_proposal._weights_file, os.path.join(output, "sigterm_weights.pt"))
    rc2, child, second_wall = _run_child("standard_resume", output)
    if child is None:
        raise RuntimeError(f"the resumed child exited with {rc2} and no result")
    analytic = -math.log(400.0)
    result = dict(
        sigterm_exit_code=rc,
        pickled_iteration=int(pickled.iteration),
        pickled_likelihood_evaluations=int(pickled._previous_likelihood_evaluations),
        pickled_checkpoint_iterations=list(pickled.history["checkpoint_iterations"]),
        first_child_wall_s=first_wall,
        resumed_child_exit_code=rc2,
        resumed_child_wall_s=second_wall,
        analytic=analytic,
        **child,
    )
    emit("resume_standard", **result)
    checks = {
        "exit code 130 after SIGTERM": rc == 130,
        "resumed child exit code 0": rc2 == 0,
        "iteration at resume is the pickled one": child["at_resume"]["iteration"] == result["pickled_iteration"],
        "likelihood evaluations carried over": child["at_resume"]["likelihood_evaluations"]
        >= result["pickled_likelihood_evaluations"],
        "flow weights bitwise equal to the weights file": child["weights_bitwise"],
        "|pull| < 3": math.isfinite(child["pull"]) and abs(child["pull"]) < PULL_LIMIT,
        "K1 forward and backward launched after resume": child["k1_launches"] > 0
        and child["k1_backward_launches"] > 0,
        "result.json log_evidence is logZ": child["result_json_log_evidence"] == child["logZ"],
        "result.json posterior samples": child["result_json_posterior_samples"] == child["posterior_samples"],
    }
    if not all(checks.values()):
        raise RuntimeError(f"resume_standard: failed {[k for k, v in checks.items() if not v]}")
    return result


def phase_resume_ins(output):
    """``FLAGSHIP_INS`` checkpointed at the end of its third level in a
    child, then resumed on the card in another: log_q recomputed through
    the reloaded levels (K1 forward) and logZ against the recorded ones,
    then the run finished without the level cap."""
    rc, first, first_wall = _run_child("ins_first", output)
    if rc != 0 or first is None:
        raise RuntimeError(f"the INS child exited with {rc}")
    rc2, child, second_wall = _run_child("ins_resume", output)
    if rc2 != 0 or child is None:
        raise RuntimeError(f"the resumed INS child exited with {rc2}")
    result = dict(
        first_child_wall_s=first_wall,
        checkpoint_s=first["checkpoint_s"],
        checkpoint_bytes=first["checkpoint_bytes"],
        resumed_child_wall_s=second_wall,
        log_q_tol=RESUME_LOG_Q_TOL,
        logZ_tol=RESUME_LOGZ_TOL,
        **child,
    )
    emit("resume_ins", **result)
    checks = {
        "resumed at level 3": child["iteration_at_resume"] == child["recorded_iteration"] == 3,
        "log_q within 1e-5": child["log_q_max_abs_err"] <= RESUME_LOG_Q_TOL,
        "logZ within 1e-8": abs(child["logZ_at_resume"] - child["recorded_logZ"]) <= RESUME_LOGZ_TOL,
        "|pull| < 3": math.isfinite(child["pull"]) and abs(child["pull"]) < PULL_LIMIT,
        "K1 launched after resume": child["k1_launches"] > 0 and child["k1_backward_launches"] > 0,
        "levels added after resume": child["iterations"] > 3,
    }
    if not all(checks.values()):
        raise RuntimeError(f"resume_ins: failed {[k for k, v in checks.items() if not v]}")
    return result


def phase_resume_on_cpu(output):
    """The ``resume_standard`` SIGTERM checkpoint resumed in this process
    on the CPU: the sampler's state bit for bit as pickled, and its flow
    against the same checkpoint resumed on the card."""
    import pickle

    from nessai_tpu_torch.samplers.nestedsampler import NestedSampler
    from nessai_tpu_torch.utils.profiling import FLAGSHIP
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    path = os.path.join(output, "sigterm.pkl")
    weights = os.path.join(output, "sigterm_weights.pt")
    with open(path, "rb") as f:
        pickled = pickle.load(f)
    configs = dict(flow_config=FLAGSHIP["flow_config"], training_config=FLAGSHIP["training_config"])
    on_cpu = NestedSampler.resume(path, IntegrationTestModel(2), device="cpu", weights_path=weights, **configs)
    on_gpu = NestedSampler.resume(path, IntegrationTestModel(2), device="cuda", weights_path=weights, **configs)
    # the rebuilt flow draws its seed from the run's generator, as in
    # the JAX package
    pickled.rng.integers(0, 2**31 - 1)
    state_attrs = ("logZ", "oldZ", "logw", "info", "logLs", "log_vols", "nlives")
    checks = {
        "iteration": on_cpu.iteration == pickled.iteration,
        "live points": _same_bits(on_cpu.live_points, pickled.live_points),
        "nested samples": _same_bits(on_cpu.nested_samples_array, pickled.nested_samples_array),
        "logZ state": all(_same_bits(getattr(on_cpu.state, a), getattr(pickled.state, a)) for a in state_attrs),
        "host rng": on_cpu.rng.bit_generator.state == pickled.rng.bit_generator.state,
        "flow on the cpu": next(on_cpu.flow_proposal.flow.flow.parameters()).device.type == "cpu",
    }
    # the checkpoint's 1000 live points in the flow's space
    from nessai_tpu_torch.livepoint import live_points_to_array

    proposal = on_cpu.flow_proposal
    x_prime, _ = proposal.rescale(proposal._convert_to_x(on_cpu.live_points))
    x = live_points_to_array(x_prime, proposal.prime_parameters)
    log_prob_cpu = proposal.flow.log_prob(x)
    log_prob_gpu = on_gpu.flow_proposal.flow.log_prob(x)
    err = float(np.abs(log_prob_cpu - log_prob_gpu).max())
    checks["log_prob cpu vs gpu"] = err <= CPU_LOG_PROB_TOL
    emit("resume_on_cpu", iteration=int(on_cpu.iteration), points=len(x), log_prob_max_abs_err=err,
         log_prob_range=[float(log_prob_cpu.min()), float(log_prob_cpu.max())], tol=CPU_LOG_PROB_TOL, checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"resume_on_cpu: failed {[k for k, v in checks.items() if not v]}")
    return dict(log_prob_max_abs_err=err)


def phase_resume(seconds):
    """The three resume phases in one fresh directory."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_resume_") as output:
        standard = os.path.join(output, "standard")
        ins = os.path.join(output, "ins")
        os.makedirs(standard)
        os.makedirs(ins)
        results = dict(resume_standard=timed(seconds, "resume_standard", phase_resume_standard, standard))
        results["resume_ins"] = timed(seconds, "resume_ins", phase_resume_ins, ins)
        timed(seconds, "resume_on_cpu", phase_resume_on_cpu, standard)
    return results


def phase_pool_reparam_angle(angle):
    """``FLAGSHIP_REPARAM_ANGLE`` with its host likelihood on a pool of
    two worker processes: the same bits, iterations and likelihood
    count as ``flagship_reparam_angle``, and the pool closed at the
    end."""
    import multiprocessing

    from nessai_tpu_torch.utils.profiling import FLAGSHIP_REPARAM_ANGLE
    from nessai_tpu_torch.utils.testing import AngleModel

    config = dict(FLAGSHIP_REPARAM_ANGLE, n_pool=2)
    fs, model, nested, wall, launches = _drive(config, _k1_counters(), model=AngleModel())
    children = multiprocessing.active_children()
    result = dict(
        logZ=fs.logZ,
        logZ_err=fs.logZ_error,
        iterations=int(fs.ns.iteration),
        likelihood_evaluations=int(model.likelihood_evaluations),
        likelihood_time_s=model.likelihood_evaluation_time.total_seconds(),
        wall_s=wall,
        pool_closed=model.pool is None,
        live_children=len(children),
        **launches,
    )
    emit("pool_reparam_angle", **result)
    checks = {
        "logZ bits": result["logZ"] == angle["logZ"],
        "iterations": result["iterations"] == angle["iterations"],
        "likelihood evaluations": result["likelihood_evaluations"] == angle["likelihood_evaluations"],
        "pool closed": result["pool_closed"] and not children,
        "K1 launched": launches["k1_launches"] > 0 and launches["k1_backward_launches"] > 0,
    }
    if not all(checks.values()):
        raise RuntimeError(f"pool_reparam_angle: failed {[k for k, v in checks.items() if not v]}")
    return result


def phase_flagship_checkpointing(flagship):
    """The RealNVP flagship with ``checkpointing=True``: weight files after
    every training and the final checkpoint draw nothing from any random
    stream, so the bits are the pinned run's."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    result, nested, fs = _flagship_run(dict(FLAGSHIP, checkpointing=True), _k1_counters())
    result["unpinned_wall_s"] = flagship["wall_s"]
    emit("flagship_checkpointing", **result)
    if result["logZ"] != flagship["logZ"] or result["iterations"] != flagship["iterations"]:
        raise RuntimeError(f"checkpointing moved the flagship: {result['logZ']} != {flagship['logZ']}")
    if result["k1_launches"] != flagship["k1_launches"]:
        raise RuntimeError("checkpointing changed the flagship's K1 launches")
    _check_run(result, nested, fs)
    return result


def timed(seconds, name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its wall time in ``seconds[name]``."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    seconds[name] = time.perf_counter() - start
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--child"]:
        CHILDREN[sys.argv[2]](sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--eggbox-in-full"]:
        # the sampler's progress (its trainings) on stderr
        logging.getLogger("nessai_tpu_torch").setLevel(logging.INFO)
        logging.getLogger("nessai_tpu_torch").addHandler(logging.StreamHandler())
        seconds = {}
        try:
            timed(seconds, "environment", phase_environment)
            timed(seconds, "build", phase_build)
            timed(seconds, "flagship_eggbox", phase_flagship_eggbox, max_iteration=None)
            emit("seconds", **seconds, total=sum(seconds.values()))
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    try:
        from nessai_tpu_torch.utils.profiling import FLAGSHIP, FLAGSHIP_NSF

        seconds = {}
        smi = timed(seconds, "environment", phase_environment)
        timed(seconds, "build", phase_build)
        max_err = timed(seconds, "k1_vs_plain", phase_k1)
        max_err_layer, main_layer = timed(seconds, "k1_layer_vs_plain", phase_k1_layer)
        max_err_k2, main_k2 = timed(seconds, "k2_vs_plain", phase_k2)
        timed(seconds, "flow_realnvp", phase_flow, FLAGSHIP, "realnvp", scale=0.05)
        # the reference in float64: the plain spline in float32 strays
        # from the exact spline by more than the kernel, which computes
        # in double (PERF.md, Findings)
        timed(seconds, "flow_nsf", phase_flow, FLAGSHIP_NSF, "nsf",
              scale=NSF_FLOW_PERTURBATION, reference_dtype=torch.float64)
        phase_new_flows(seconds)
        timed(seconds, "ins_flow", phase_ins_flow)
        timed(seconds, "reparam_inverse", phase_reparam_inverse)
        flagship = timed(seconds, "flagship", phase_flagship)
        flagship_nsf = timed(seconds, "flagship_nsf", phase_flagship_nsf)
        split = timed(seconds, "flagship_fuse_likelihood_false", phase_flagship_fuse_likelihood_false, flagship)
        flagship_ins = timed(seconds, "flagship_ins", phase_flagship_ins)
        mixture = timed(seconds, "flagship_ins_mixture", phase_flagship_ins_mixture)
        options = timed(seconds, "ins_options", phase_ins_options)
        inversion = timed(seconds, "flagship_reparam_inversion", phase_flagship_reparam_inversion)
        angle = timed(seconds, "flagship_reparam_angle", phase_flagship_reparam_angle)
        lu = timed(seconds, "flagship_lu", phase_flagship_lu)
        hypercube = timed(seconds, "flagship_ins_hypercube", phase_flagship_ins_hypercube)
        eggbox = timed(seconds, "flagship_eggbox", phase_flagship_eggbox)
        augmented = timed(seconds, "flagship_augmented", phase_flagship_augmented)
        standard_options = timed(seconds, "standard_options", phase_standard_options)
        checkpointing = timed(seconds, "flagship_checkpointing", phase_flagship_checkpointing, flagship)
        pool = timed(seconds, "pool_reparam_angle", phase_pool_reparam_angle, angle)
        resumed = phase_resume(seconds)
        emit("seconds", **seconds, total=sum(seconds.values()))
    except Exception:
        traceback.print_exc()
        return 1
    kernels = []
    runs = {
        "flagship": flagship,
        "flagship_nsf": flagship_nsf,
        "flagship_fuse_likelihood_false": split,
        "flagship_ins": flagship_ins,
        "flagship_ins_mixture": mixture,
        **options,
        "flagship_reparam_inversion": inversion,
        "flagship_reparam_angle": angle,
        "flagship_lu": lu,
        "flagship_ins_hypercube": hypercube,
        "flagship_eggbox": eggbox,
        "flagship_augmented": augmented,
        **standard_options,
        "flagship_checkpointing": checkpointing,
        "pool_reparam_angle": pool,
        # the resumed processes' runs
        "resume_standard": resumed["resume_standard"],
        "resume_ins": resumed["resume_ins"],
    }
    for name, replaces, key in (
        ("affine_coupling", "nessai_tpu/ops/coupling_pallas.py:56", "k1_launches"),
        # the JAX package's backward: jax.vjp of the jnp reference
        ("affine_coupling_backward", "nessai_tpu/ops/coupling_pallas.py:112", "k1_backward_launches"),
    ):
        row = main_layer[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": "nessai_tpu_torch/csrc/affine_coupling.cu",
                "replaces": replaces,
                "launches": flagship[key],
                "launches_by_run": {run: r[key] for run, r in runs.items()},
                "max_abs_err": max(max_err_layer[name], max_err if name == "affine_coupling" else 0.0),
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                # no single PyTorch call computes a soft-clamped affine
                # coupling with its row log-determinant
                "library_ms": None,
                "timer": row["timer"],
                "plain_timer": row["plain_timer"],
                "shape": [K1_LAYER_MAIN_SHAPE[0], K1_LAYER_MAIN_SHAPE[1]],
                "mask": list(K1_LAYER_MAIN_SHAPE[2]),
                "card": smi,
            }
        )
    for name, replaces, key in (
        ("rqs", "nessai_tpu/ops/rqs_pallas.py:180", "rqs_launches"),
        # the JAX package's backward: jax.vjp of the jnp reference
        ("rqs_backward", "nessai_tpu/ops/rqs_pallas.py:228", "rqs_backward_launches"),
    ):
        row = main_k2[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": "nessai_tpu_torch/csrc/rqs.cu",
                "replaces": replaces,
                "launches": flagship_nsf[key],
                "launches_by_run": {run: r[key] for run, r in runs.items()},
                "max_abs_err": max_err_k2[name],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                # no single PyTorch call computes a rational-quadratic spline
                "library_ms": None,
                "timer": row["timer"],
                "plain_timer": row["plain_timer"],
                "shape": list(K2_MAIN_SHAPE),
                "card": smi,
            }
        )
    for name, replaces, key in (
        ("rqs_unit", "nessai_tpu/ops/rqs_pallas.py:180", "rqs_unit_launches"),
        ("rqs_unit_backward", "nessai_tpu/ops/rqs_pallas.py:228", "rqs_unit_backward_launches"),
    ):
        row = main_k2[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": "nessai_tpu_torch/csrc/rqs.cu",
                "replaces": replaces,
                # the JAX package computes tails=None with its jnp spline
                "variant": "tails=None: the unit box, K + 1 learned derivatives (nessai_tpu/flows/rqs.py:28)",
                "launches": hypercube[key],
                "launches_by_run": {run: r[key] for run, r in runs.items()},
                "max_abs_err": max_err_k2[name],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": None,
                "timer": row["timer"],
                "plain_timer": row["plain_timer"],
                "shape": list(K2_UNIT_MAIN_SHAPE),
                "card": smi,
            }
        )
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
