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
against theirs, and K2's backward of the inverse direction against
autograd of the plain inverse (``k2_inverse_backward_vs_plain``), then
reached through the public flow API by a reverse-KL training of the NSF
flagship's flow (``nsf_inverse_training``); the nested-sampling consume/insert scan kernel
(``csrc/ns_scan.cu``) against its plain version and the host pass's
ordering, bit for bit, on every memory path (registers, shared memory, ids
or all in global scratch)
and at their boundaries, with a terminal pool, an all-accept pool, NaN
and infinite candidates and runs of ties (``ns_scan_vs_plain``); the flagship RealNVP and the neural-spline flow, and
the flows the flagships do not build (LU and SVD linear layers, MAF, the
logit pre-transform, a LARS base, the unit-hypercube spline on a uniform
base) and the RealNVP and NSF conditioned on a one-hot context of 8
labels (``realnvp_context``, ``nsf_context``, with the gradient), on the
GPU against the same weights on the CPU; the importance nested sampler's
per-level flows (``log_prob_all`` and single-level passes at 16,384
rows) on the GPU against the CPU; the flagship nested-sampling run
(``bench.py``'s configuration) through ``FlowSampler(..., device="cuda")``,
and the same run with the neural spline flow, both at their defaults:
the device populate loop
with its soft budget, the prior populated on the device and the scan
chained onto both (K1 or K2 counted inside the loop), the flagship again
with each bookkeeping flag off and the same bits (``flagship_device_loop``,
``flagship_nsf_device_loop``), and on the rounds populate
(``flagship_rounds``, with ``flagship_fuse_likelihood_false`` held to its
bits); the device mesh: one data-parallel step of the RealNVP and NSF
flagships' flows on a virtual mesh of two replicas on ``cuda:0`` and on
``get_mesh()`` against the single-device step (``mesh_dp_step``), the
RealNVP flagship on the virtual mesh (``flagship_mesh``: the rounds
populate cut over the mesh, data-parallel training) and the importance
nested sampler's flagship on it (``flagship_ins_mesh``); the importance nested sampler's flagship (``FlowSampler(..., importance_nested_sampler=True,
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
(``flagship_augmented``); the experimental proposals: the MCMC example in
full (``flagship_mcmc``) and the RealNVP flagship with the clustering
proposal (``flagship_clustering``); short runs of the standard sampler's options
(``standard_options_*``: the truncation rules, the likelihood split,
the iteration cap, the training schedule, the uninformed proposal, the
shrinkage, the optimisers and training options, the augmented marginal,
the unit hypercube); the GW examples (``nessai_tpu_torch/examples/gw``):
each device likelihood against its float64 host likelihood at 4096 prior
draws (``gw_likelihood_gpu_vs_host``), the basic model in full against the
JAX package's logZ measured on a CPU (``gw_basic``), its host-likelihood
twin with ``likelihood_callback`` (``gw_callback``) and the importance
nested sampler on it with the redraw (``gw_ins``), both against
``gw_basic``, and the 9-parameter sky-location model (12 prime
dimensions), the toy chirp and the calibration model at full width to an
iteration cap (``gw_full``, ``gw_toy_cbc``, ``gw_calibration``); the
class members that reach the kernels (``members``:
``FlowModel.sample_and_log_prob`` in both forms, ``Flow.loss`` with its
backward, a step under ``freeze_transform``) on the GPU against the CPU;
the example modules (``nessai_tpu_torch/examples``, ``EXAMPLE_PHASES``),
each at its script's width, in full or to the cap of ``EXAMPLE_CAPS``; a
``kernels`` summary. From ``flagship_mesh`` on, the INS mixture, its
option runs, the hypercube run and the standard sampler's option runs
(``BACKGROUND_PHASES``) run in a second process, and the example phases in
a third, beside the others. The
last line is ``{"ok": true, "device": {...}}``. Any failing phase ends
the script with a non-zero exit code and without that line. Without a
GPU the script exits with code 2 at once. ``python3 chip_smoke.py
--eggbox-in-full`` builds the kernels and runs the egg-box example to
its end (about 40 minutes), with the pull's gate; ``python3 chip_smoke.py
--gw-in-full`` runs the full, toy, calibration and INS GW examples to
their ends, each against the JAX package's CPU logZ where one was
measured.

Imports nothing of JAX or of the JAX package.
"""

import functools
import hashlib
import json
import logging
import math
import os
import shutil
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
#: fixed mask) at 2000 rows, then the device populate loop's batches of
#: the flagship (4096 rows) and of the egg-box (8192 rows), then
#: ``K1_LAYER_GW_SHAPES``; new rows go last, so that the rows before them
#: keep their inputs
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
    (4096, 2, (1, 0)),
    (8192, 2, (0, 1)),
]
#: the GW examples' training batches: the basic model's 5-D flow (900
#: rows, both alternating masks, two and three transformed columns) and
#: the full model's 12-D flow (batches of 1000 rows, six transformed
#: columns: the 16-byte loads)
K1_LAYER_GW_SHAPES = [
    (900, 5, (0, 1, 0, 1, 0)),
    (900, 5, (1, 0, 1, 0, 1)),
    (1000, 12, (0, 1) * 6),
    (1000, 12, (1, 0) * 6),
]
K1_LAYER_SHAPES += K1_LAYER_GW_SHAPES
#: shape of the kernels-line numbers of both K1 kernels: a flagship
#: training step's coupling
K1_LAYER_MAIN_SHAPE = (900, 2, (1, 0))
#: the rows whose fused kernels are timed (every row is checked): the main
#: shape, the augmented flow's and the GW examples' (the others are
#: checked only, for the script's time; their times are in PERF.md)
K1_LAYER_FUSED_TIMED_SHAPES = (K1_LAYER_MAIN_SHAPE, (2000, 4, (1, 1, 0, 0))) + tuple(
    row for row in K1_LAYER_SHAPES if row[1] in (5, 12)
)
#: the bare K1's timed shape (every shape is checked)
K1_TIMED_SHAPE = (900, 1)
#: calls in each profile of the plain and unfused paths of the coupling
#: layer (11-39 GPU records a call); the fused kernels keep 200
K1_LAYER_OTHER_PROFILE_CALLS = 50
#: the rows whose plain and unfused paths are timed too (the flagship's
#: training step and the augmented flow's); every row times the fused
#: kernels and checks all three paths (profiler sessions cut for the time
#: limit when the egg-box and option runs joined the script)
K1_LAYER_TIMED_SHAPES = (K1_LAYER_MAIN_SHAPE, (2000, 4, (1, 1, 0, 0)))
Y_ATOL, Y_RTOL, LD_ATOL = 1e-6, 1e-5, 1e-5
#: K1 against the float64 function, beside the gate above: at every row
#: the kernel's y is at most this many times as far from the float64
#: plain version as the float32 plain version is (the ratio was 0.77 to
#: 1.52 over the rows on the H100; both round in float32, and where
#: x e^s and t cancel their errors are of one size, PERF.md)
K1_Y_VS_FLOAT64_MULTIPLE = 2.0
#: the rows of the GW examples' training batches (appended last, D = 5
#: and 12) are held to the float64 function by two statistics of
#: ``float64_distances``, each against the float32 plain version's. The
#: largest absolute distance is one or two elements' of the largest |y|
#: (an ulp of s moves y by y ulps): its ratio read 3.912 at most over 300
#: fresh inputs of each of the six shape rows of ``tools/k1_accuracy.py``
#: in each direction (3600 in all; 0-1.7% of each 300 above 2, the median
#: 1.0), so its limit is 5. The mean of |y - y64| / max(|y64|, 1) over
#: the row read 1.071 at most there (0.918-1.046 over this script's
#: rows), so its limit is 1.25.
K1_GW_Y_VS_FLOAT64_MAX_MULTIPLE = 5.0
K1_GW_Y_VS_FLOAT64_MEAN_MULTIPLE = 1.25
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
#: K2's backward of the inverse direction, against autograd of the plain
#: version's inverse (inputs from a generator of its own, so the rows
#: above keep theirs): the NSF flagship's batch with linear tails, the
#: unit-hypercube run's training batch with tails=None, linear tails at
#: 24, 32 and 40 bins (one warp an element, then chunks of 32 bins) and a
#: level's draws of 10,000 rows with tails=None; the first row is the
#: kernels line's. Held to the forward-direction backward's float64
#: tolerance (K2_F64_ATOL + K2_F64_RTOL against the float64 plain
#: version); the distance from the float32 plain version is printed.
K2_INVERSE_BACKWARD_SHAPES = [
    (900, 1, 8, "linear"),
    (1000, 2, 8, None),
    (2048, 2, 24, "linear"),
    (2048, 2, 32, "linear"),
    (2048, 2, 40, "linear"),
    (10000, 2, 8, None),
]
#: the flows' inverse under autograd through the public flow API: Adam
#: steps of the reverse KL divergence of the NSF flagship's flow from a
#: Gaussian, each through K2's inverse and its inverse backward
NSF_INVERSE_TRAINING_STEPS = 20
NSF_INVERSE_TRAINING_ROWS = 1000
#: the data-parallel step against the single-device step, one Adam step
#: (lr 1e-3) on a batch of the flagship's 900 rows: the loss to a
#: relative 1e-5, the primary's summed gradient of each parameter tensor
#: to 1e-5 of that tensor's largest single-device gradient (Adam's first
#: step moves a parameter by about lr * sign(g), so the parameters alone
#: would show the gradient's signs, not its size) and every parameter to
#: 1e-6 (a thousandth of the step); the shards' sums and the replicas'
#: summed gradients round otherwise than one pass over the batch (2e-7
#: and 7e-8 at most on the CPU)
MESH_DP_ROWS = 900
MESH_DP_LOSS_RTOL, MESH_DP_GRAD_RTOL, MESH_DP_PARAM_ATOL = 1e-5, 1e-5, 1e-6
#: the virtual mesh of the card: two replicas on one GPU
VIRTUAL_MESH_DEVICES = ("cuda:0", "cuda:0")
#: Depth cuts for the script's time limit (1200 s): with the mesh phases
#: the whole script took 1164.0 s of phases on a slow host (868.7-893.0 s
#: before them on a faster one), so the two largest runs are cut where the
#: cut costs no gate, their training set (and so the batches an epoch) being
#: what their time scales with: the unit-hypercube example at 4000 live
#: points (10,000 as written) and the Gaussian mixture at 1000 live
#: points, an ESS of 1500 and a redraw to 1000 (2000, 3000 and 2000 as
#: written); each keeps its |pull| < 3 and its other gates. Neither is cut
#: further for the GW phases: the mixture at 600 live points took
#: 7 levels and 59.1 s against 5 and 35.2 s, and the hypercube at 2000
#: ended with an ESS of 29 against 1408 (PERF.md).
HYPERCUBE_SMOKE_NLIVE = 4000
MIXTURE_SMOKE = dict(nlive=1000, ess=1500, n_posterior_samples=1000)
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
#: kernels are timed with 200 calls at the main shapes and the rows of
#: K2_SHAPES_MORE; every shape is checked)
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
#: the context width of the conditional flow checks: the clustering
#: proposal's one-hot label at its default of 8 clusters
CONTEXT_FEATURES = 8
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
            timed = (n, d) == K1_TIMED_SHAPE
            ms, _, timer = device_time_ms(kernel) if timed else (None, None, None)
            plain_ms, plain_kernels, plain_timer = device_time_ms(plain) if timed else (None, None, None)
            bound, bound_by = k1_bound_ms(n, d)
            row[tag] = {
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "timer": timer,
                "plain_timer": plain_timer,
                "plain_kernels_per_call": plain_kernels,
                "call_ms": time_ms(kernel, repeats=K1_EVENT_REPEATS) if timed else None,
                "plain_call_ms": time_ms(plain, repeats=K1_EVENT_REPEATS) if timed else None,
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
            f"of 50 back-to-back calls; at {list(K1_TIMED_SHAPE)} only (None elsewhere)"
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
                    name: device_time_ms(call)
                    if name in ("forward_fused", "backward_fused") and (n, D, mask) in K1_LAYER_FUSED_TIMED_SHAPES
                    else device_time_ms(call, calls=K1_LAYER_OTHER_PROFILE_CALLS)
                    if (n, D, mask) in K1_LAYER_TIMED_SHAPES else (None, None, None)
                    for name, call in timed_calls.items()
                }
            del graph, timed_calls
            fwd_bound, fwd_by = k1_layer_bound_ms(n, D, n_tr)
            bwd_bound, bwd_by = k1_layer_bound_ms(n, D, n_tr, backward=True, inverse=inverse)
            d64 = float64_distances(y, y_ref, y64)
            row[tag] = {
                "max_abs_err": err,
                "y_max_abs_err_vs_float64": d64["max_abs"],
                "plain_y_max_abs_err_vs_float64": d64["plain_max_abs"],
                "y_mean_scaled_err_vs_float64": d64["mean_scaled"],
                "plain_y_mean_scaled_err_vs_float64": d64["plain_mean_scaled"],
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
            limits = (
                {"max_abs": K1_GW_Y_VS_FLOAT64_MAX_MULTIPLE, "mean_scaled": K1_GW_Y_VS_FLOAT64_MEAN_MULTIPLE}
                if (n, D, mask) in K1_LAYER_GW_SHAPES else {"max_abs": K1_Y_VS_FLOAT64_MULTIPLE}
            )
            for stat, multiple in limits.items():
                err64, plain_err64 = d64[stat], d64[f"plain_{stat}"]
                if err64 > multiple * plain_err64:
                    raise RuntimeError(
                        f"k1 layer at {(n, D, mask)} {tag}: {err64} from the float64 function ({stat}), over "
                        f"{multiple} x the float32 plain version's {plain_err64}"
                    )
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
                   "forward_vs_unfused_path": "bitwise",
                   "y_vs_float64_multiple_of_plain_float32": K1_Y_VS_FLOAT64_MULTIPLE,
                   "y_vs_float64_distance": "the largest |y - y64|",
                   "gw_rows": [list(s[:2]) + [list(s[2])] for s in K1_LAYER_GW_SHAPES],
                   "gw_rows_y_vs_float64_multiples_of_plain_float32": {
                       "largest |y - y64|": K1_GW_Y_VS_FLOAT64_MAX_MULTIPLE,
                       "mean of |y - y64| / max(|y64|, 1)": K1_GW_Y_VS_FLOAT64_MEAN_MULTIPLE}},
        timing=(
            "*_ms, *_records_per_call: GPU time and GPU records per call from "
            f"torch.profiler over 200 calls (fused; None outside {list(K1_LAYER_FUSED_TIMED_SHAPES)}) or "
            f"{K1_LAYER_OTHER_PROFILE_CALLS} "
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


def float64_distances(y, y_plain, y64) -> dict:
    """How far the kernel's ``y`` and the float32 plain version's
    ``y_plain`` are from ``y64``, the plain version run in float64 on the
    same inputs: the largest absolute distance and the mean of
    ``|y - y64| / max(|y64|, 1)`` over every element, for each."""
    y64 = y64.double()
    scale = torch.clamp(y64.abs(), min=1.0)
    out = {}
    for key, value in (("", y), ("plain_", y_plain)):
        d = (value.double() - y64).abs()
        out[f"{key}max_abs"] = float(d.max()) if d.numel() else 0.0
        out[f"{key}mean_scaled"] = float((d / scale).mean()) if d.numel() else 0.0
    return out


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
        # the kernels are timed at the main shapes and the rows of
        # K2_SHAPES_MORE
        timed = is_main or (n, d, K, tails) in K2_SHAPES_MORE
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
            ms, _, timer = device_time_ms(kernel) if timed else (None, None, None)
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
                "call_ms": time_ms(kernel, **K2_EVENT_TIMING) if timed else None,
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
        ms, _, timer = device_time_ms(kernel) if timed else (None, None, None)
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
            "call_ms": time_ms(kernel, **K2_EVENT_TIMING) if timed else None,
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


def phase_k2_inverse_backward():
    """K2's backward of the inverse direction against autograd of the
    plain version's inverse, on the card, at ``K2_INVERSE_BACKWARD_SHAPES``:
    every gradient (in y and the three parameter sets, for a random linear
    loss of both outputs) to the float64 plain version (its distance from
    the float32 plain version, as a share of that version's largest
    gradient, is printed beside the float32 version's own distance from
    float64), one launch a backward; its time (200 calls) and its bound at
    every row, the plain graph's time at the first (the kernels line's)."""
    from nessai_tpu_torch.ops.rqs import _launch_backward, rqs, rqs_plain
    from nessai_tpu_torch.utils.profiling import device_time_ms

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    rows = []
    max_err = {"linear": 0.0, None: 0.0}
    for n, d, K, tails in K2_INVERSE_BACKWARD_SHAPES:
        row_start = time.perf_counter()
        x, w, h, dd = _k2_inputs(gen, n, d, K, tails)
        w_x = torch.randn(n, d, device="cuda", generator=gen)
        w_ld = torch.randn(n, d, device="cuda", generator=gen)
        grads, graphs = {}, {}
        before = rqs.inverse_backward_launches
        for name, f, dtype in (
            ("kernel", rqs, torch.float32),
            ("plain64", rqs_plain, torch.float64),
            ("plain32", rqs_plain, torch.float32),
        ):
            args = [a.detach().to(dtype).requires_grad_(True) for a in (x, w, h, dd)]
            out, ld = f(*args, True, TAIL_BOUND, tails)
            cot = (w_x.to(dtype), w_ld.to(dtype))
            grads[name] = torch.autograd.grad((out, ld), args, cot, retain_graph=True)
            graphs[name] = (out, ld, args, cot)
        torch.cuda.synchronize()
        launches = rqs.inverse_backward_launches - before
        if launches != 1:
            raise RuntimeError(f"a gradient through rqs(..., inverse=True) launched the inverse backward {launches} times")
        share = share_32 = 0.0
        for g_k, g_64, g_32 in zip(grads["kernel"], grads["plain64"], grads["plain32"]):
            torch.testing.assert_close(g_k.double(), g_64, atol=K2_F64_ATOL, rtol=K2_F64_RTOL)
            if g_32.numel():
                scale = max(g_32.abs().max().item(), 1e-30)
                share = max(share, _max_err(g_k, g_32) / scale)
                share_32 = max(share_32, _max_err(g_32, g_64) / scale)
        err = max(_max_err(a, b) for a, b in zip(grads["kernel"], grads["plain64"]))
        max_err[tails] = max(max_err[tails], err)
        out, ld, args, cot = graphs["plain32"]
        kernel = functools.partial(_launch_backward, x, w, h, dd, w_x, w_ld, TAIL_BOUND, tails, True)
        plain = functools.partial(torch.autograd.grad, (out, ld), args, cot, retain_graph=True)
        ms, _, timer = device_time_ms(kernel)
        # the plain graph's time at the kernels line's row
        plain_ms, plain_kernels, plain_timer = (
            device_time_ms(plain, calls=K2_PLAIN_PROFILE_CALLS)
            if (n, d, K, tails) == K2_INVERSE_BACKWARD_SHAPES[0] else (None, None, None)
        )
        bound, bound_by = k2_bound_ms(x, K, backward=True, tails=tails)
        rows.append(
            {
                "n": n,
                "d": d,
                "K": K,
                "tails": tails,
                "launches_per_call": launches,
                "max_abs_err": err,
                "max_share_of_largest_float32_plain_gradient": share,
                "float32_plain_share_from_float64": share_32,
                "ms": ms,
                "plain_ms": plain_ms,
                "timer": timer,
                "plain_timer": plain_timer,
                "plain_kernels_per_call": plain_kernels,
                "bound_ms": bound,
                "bound_by": bound_by,
                "seconds": time.perf_counter() - row_start,
            }
        )
        del graphs, grads
    emit(
        "k2_inverse_backward_vs_plain",
        tolerance={
            "vs_float64_plain_atol": K2_F64_ATOL,
            "vs_float64_plain_rtol": K2_F64_RTOL,
        },
        timing=(
            "ms, plain_ms: GPU time per call from torch.profiler over 200 kernel calls and "
            f"{K2_PLAIN_PROFILE_CALLS} plain calls (autograd of the float32 plain inverse's graph), or "
            f"{EVENT_FALLBACK} (timer, plain_timer); bound_ms by k2_bound_ms's rule for the backward"
        ),
        shapes=rows,
    )
    return max_err, rows[0]


def phase_nsf_inverse_training():
    """The flows' inverse under autograd through the public flow API, the
    path that reaches K2's inverse backward: ``NSF_INVERSE_TRAINING_STEPS``
    Adam steps of the reverse KL divergence of the NSF flagship's flow
    (``Flow.sample_and_log_prob``) from N((1, -1), 4 I), with every count
    set to 0 just before and read just after. Fails unless every step
    launched the inverse backward once a coupling and the divergence
    fell."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_NSF

    counters = _k1_counters()
    flow = _flagship_flow("cuda", FLAGSHIP_NSF, seed=3)
    n_couplings = sum(type(b).__name__ == "RQSCoupling" for b in flow.bijector.bijectors)
    optimiser = torch.optim.Adam(flow.parameters(), lr=1e-2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    mu = torch.tensor([1.0, -1.0], device="cuda")
    losses = []
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    start = time.perf_counter()
    for _ in range(NSF_INVERSE_TRAINING_STEPS):
        optimiser.zero_grad(set_to_none=True)
        x, log_q = flow.sample_and_log_prob(NSF_INVERSE_TRAINING_ROWS, gen)
        log_p = -0.5 * (((x - mu) / 2.0) ** 2).sum(dim=1) - 2 * math.log(2.0) - math.log(2 * math.pi)
        loss = (log_q - log_p).mean()
        loss.backward()
        optimiser.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {key: int(getattr(w, a)) for key, (w, a) in counters.items()}
    losses = torch.stack(losses).tolist()
    result = dict(
        steps=NSF_INVERSE_TRAINING_STEPS,
        rows=NSF_INVERSE_TRAINING_ROWS,
        couplings=n_couplings,
        first_losses=losses[:3],
        last_losses=losses[-3:],
        wall_s=wall,
        **launches,
    )
    emit("nsf_inverse_training", **result)
    if launches["rqs_inverse_backward_launches"] != NSF_INVERSE_TRAINING_STEPS * n_couplings:
        raise RuntimeError(
            f"{NSF_INVERSE_TRAINING_STEPS} steps through {n_couplings} couplings launched the inverse backward "
            f"{launches['rqs_inverse_backward_launches']} times"
        )
    if not all(math.isfinite(v) for v in losses) or not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise RuntimeError(f"the reverse KL did not fall: {losses}")
    return result


#: the row of the kernels line (the flagship's live set and pool,
#: unbounded); the rows are ``nessai_tpu_torch.utils.testing.ns_scan_rows``
NS_SCAN_MAIN_SHAPE = (1000, 1024)


def _host_scan(live, pool, max_accepts):
    """The ordering of the host batched pass
    (``NestedSampler._consume_from_pool_batched``) on the same pool in
    float64 numpy: skips, ``searchsorted`` and the slice shift of each
    accept. Returns (mask, consumed, ins, final_ids, n_acc) as the scan
    does. The host pass leaves a pool with NaN to ``consume_sample``,
    where ``NaN > worst`` is false and no index is recorded; here a NaN
    candidate is rejected with idx 0, the scan's count ``sum(live < p)``
    (``searchsorted`` would place NaN after every live point)."""
    llogL = live.astype(np.float64)
    n = llogL.size
    ids = np.arange(n, dtype=np.int64)
    k = pool.size
    mask = np.zeros(k, bool)
    consumed = np.full(k, -1, np.int64)
    ins = np.empty(k, np.int64)
    n_acc = 0
    pool_l = pool.astype(np.float64).tolist()
    for j, p in enumerate(pool_l):
        idx = 0 if math.isnan(p) else int(np.searchsorted(llogL, p))
        ins[j] = idx - 1
        if p > llogL[0] and n_acc < max_accepts:
            mask[j] = True
            consumed[j] = ids[0]
            llogL[0 : idx - 1] = llogL[1:idx]
            llogL[idx - 1] = p
            ids[0 : idx - 1] = ids[1:idx]
            ids[idx - 1] = n + j
            n_acc += 1
    return mask, consumed, ins, ids, n_acc


def ns_scan_bound_ms(n, k, ins, mask):
    """Least time for the scan on this data: bytes (live and pool read,
    mask, consumed, ins, final ids and the count written) against
    operations (each step's binary search, log2(n + 1) comparisons and
    two more, and on each accept the moves of its shift, two a place:
    idx - 1 places, counted from this run's insertion indices)."""
    n_bytes = 4 * n + 4 * k + k + 4 * k + 4 * k + 4 * n + 4
    moves = 2 * int(ins[mask].clip(min=0).sum())
    n_ops = k * (math.ceil(math.log2(n + 1)) + 2) + moves
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_ns_scan():
    """The consume/insert scan kernel (``csrc/ns_scan.cu``) against its
    plain version (``ns_scan_plain``, on the card) at every row of
    ``utils.testing.ns_scan_rows``: PR 11's rows with ties and -inf
    padding, unbounded and capped at 17 accepts, then the terminal pool,
    an all-accept pool, NaN and infinite candidates, runs of ties and
    each side of every path boundary. All five outputs equal, bit for
    bit, and equal to the host batched pass's ordering in float64 numpy.
    Each row names the memory path the kernel takes. Times: the kernel's
    GPU time per pool and per step (profiler over 20 calls), the plain
    version's at the main row, the host twin's wall time."""
    from nessai_tpu_torch.ops.ns_scan import memory_path, ns_scan, ns_scan_plain
    from nessai_tpu_torch.utils.profiling import device_time_ms, event_time_ms
    from nessai_tpu_torch.utils.testing import NS_SCAN_UNBOUNDED, ns_scan_rows

    rows, main = [], None
    for spec, live, pool in ns_scan_rows("cuda"):
        n, k, max_accepts = spec["nlive"], spec["pool"], spec["max_accepts"]
        live_h, pool_h = live.cpu().numpy(), pool.cpu().numpy()
        row_start = time.perf_counter()
        out = ns_scan(live, pool, max_accepts)
        torch.cuda.synchronize()
        ref = ns_scan_plain(live, pool, max_accepts)
        torch.cuda.synchronize()
        names = ("mask", "consumed", "ins", "final_ids", "n_acc")
        equal = {name: bool(torch.equal(a, b)) for name, a, b in zip(names, out, ref)}
        host_start = time.perf_counter()
        host = _host_scan(live_h, pool_h, max_accepts)
        host_s = time.perf_counter() - host_start
        out_h = [o.cpu().numpy() for o in out]
        equal_host = bool(
            all(np.array_equal(a.astype(np.int64), np.asarray(b, np.int64)) for a, b in zip(out_h[:4], host[:4]))
            and int(out_h[4]) == host[4]
        )
        ms, _, timer = device_time_ms(lambda: ns_scan(live, pool, max_accepts), calls=20)
        is_main = (
            spec["regime"] == "ties_padded" and (n, k) == NS_SCAN_MAIN_SHAPE and max_accepts == NS_SCAN_UNBOUNDED
        )
        plain_ms = event_time_ms(lambda: ns_scan_plain(live, pool, max_accepts), calls=2, warmup=1) if is_main else None
        bound, bound_by = ns_scan_bound_ms(n, k, out_h[2], out_h[0])
        row = dict(
            regime=spec["regime"],
            nlive=n,
            pool=k,
            max_accepts=max_accepts,
            memory=memory_path(n),
            accepted=int(out_h[4]),
            above_worst_live=int((pool_h > live_h[0]).sum()),
            equal_to_plain=equal,
            equal_to_host_pass=equal_host,
            max_abs_err=0.0 if all(equal.values()) else math.inf,
            ms=ms,
            us_per_step=ms * 1e3 / k,
            us_per_accept=ms * 1e3 / max(int(out_h[4]), 1),
            timer=timer,
            plain_ms=plain_ms,
            plain_timer="cuda_events" if is_main else None,
            host_twin_ms=host_s * 1e3,
            bound_ms=bound,
            bound_by=bound_by,
            seconds=time.perf_counter() - row_start,
        )
        rows.append(row)
        if is_main:
            main = row
    emit(
        "ns_scan_vs_plain",
        tolerance="exact: every output equal to the plain version's and to the host pass's ordering",
        timing=(
            "ms: GPU time per pool from torch.profiler over 20 calls, or " + EVENT_FALLBACK + "; plain_ms: "
            "CUDA-event time per call of the plain version on the card over 2 calls, at the main row; "
            "host_twin_ms: wall time of one call of the host batched pass's ordering in numpy"
        ),
        rows=rows,
    )
    bad = [(r["regime"], r["nlive"], r["pool"], r["max_accepts"]) for r in rows
           if not (all(r["equal_to_plain"].values()) and r["equal_to_host_pass"])]
    if bad:
        raise RuntimeError(f"the scan kernel disagrees with its plain version or the host pass at {bad}")
    paths = {r["memory"] for r in rows}
    if paths != {"register", "shared", "global_ids", "global"}:
        raise RuntimeError(f"the scan's rows took the memory paths {sorted(paths)}, not all four")
    return main


def _flagship_flow(device, config, seed=0, dims=2):
    from nessai_tpu_torch.flows import configure_model

    flow = configure_model(dict(config["flow_config"], n_inputs=dims, seed=seed))
    return flow.to(device)


def phase_flow(config, name, scale, seed=7, reference_dtype=torch.float32, dims=2, inputs="normal",
               context_features=None):
    """The flagship's flow (``config``, on ``dims`` dimensions) on the GPU
    against the same weights on the CPU in ``reference_dtype``, every
    weight perturbed by ``scale`` so that the couplings are not the
    identity; ``inputs="unit"`` feeds it points of the unit hypercube (the
    domain of a logit pre-transform or of a flow on the unit box). With
    ``context_features`` the flow is conditional (every coupling's net
    takes ``[x_id, context]``), each row gets a one-hot context, and the
    gradient of the mean log-density in every weight is held too (K1's or
    K2's backward kernel on the GPU)."""
    if context_features:
        config = dict(config, flow_config=dict(config["flow_config"], context_features=context_features))
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
    context = None
    if context_features:
        labels = np.random.default_rng(seed + 5).integers(0, context_features, len(x))
        context = torch.as_tensor(np.eye(context_features, dtype=np.float32)[labels])

    def on(device, dtype=torch.float32):
        return None if context is None else context.to(device, dtype)

    errs = {}
    shares = {}
    largest = {}
    with torch.no_grad():
        for method, f in (
            ("forward", lambda fl, a, c: fl(a, c)),
            ("inverse", lambda fl, a, c: fl.inverse(a, c)),
            ("log_prob", lambda fl, a, c: (fl.log_prob(a, c),)),
        ):
            out_gpu = f(flow_gpu, x.cuda(), on("cuda"))
            out_cpu = f(flow_cpu, x.to(reference_dtype), on("cpu", reference_dtype))
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
        z_cpu, _ = flow_cpu(x.to(reference_dtype), on("cpu", reference_dtype))
    gradient = None
    if context is not None:
        gradient = _flow_gradient_check(flow_gpu, flow_cpu, x, on("cuda"), on("cpu", reference_dtype),
                                        reference_dtype)
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
        context_features=context_features,
        gradient=gradient,
    )


def _flow_gradient_check(flow_gpu, flow_cpu, x, context_gpu, context_cpu, reference_dtype):
    """The gradient of the mean log-density in every weight, on the GPU
    (the backward kernels) against the CPU in ``reference_dtype``, each
    to ``GRAD_ATOL`` and ``GRAD_RTOL`` of the largest reference gradient
    of its weight. Returns the largest error and share of the
    tolerance."""
    grads = []
    for flow, a, c in ((flow_gpu, x.cuda(), context_gpu), (flow_cpu, x.to(reference_dtype), context_cpu)):
        flow.zero_grad(set_to_none=True)
        (-flow.log_prob(a, c).mean()).backward()
        grads.append({n: p.grad.detach().cpu().to(reference_dtype) for n, p in flow.named_parameters()})
    err = share = 0.0
    for name, ref in grads[1].items():
        diff = (grads[0][name] - ref).abs().max().item()
        limit = GRAD_ATOL + GRAD_RTOL * ref.abs().max().item()
        err, share = max(err, diff), max(share, diff / limit)
        if diff > limit:
            raise RuntimeError(f"the gradient in {name} differs by {diff} (limit {limit})")
    return dict(weights=len(grads[1]), atol=GRAD_ATOL, rtol_of_largest=GRAD_RTOL, max_abs_err=err,
                max_share_of_tolerance=share)


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
        device_steps=int(getattr(ns, "_n_device_steps", 0)),
        insertion_indices_sha256=hashlib.sha256(np.asarray(ns.insertion_indices, np.int64).tobytes()).hexdigest(),
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


class _LaunchesInLoop:
    """Counts the kernel launches made inside the device populate loop's
    rounds (``FlowProposal._device_loop_round``) while it is entered."""

    def __enter__(self):
        from nessai_tpu_torch.ops import coupling, rqs
        from nessai_tpu_torch.proposal.flowproposal.flowproposal import FlowProposal

        self.counts = dict(k1_launches_in_loop=0, rqs_launches_in_loop=0)
        self._real = real = FlowProposal._device_loop_round
        counts = self.counts

        def counted(proposal, *args, **kwargs):
            k1, k2 = coupling.affine_coupling.launches, rqs.launches
            out = real(proposal, *args, **kwargs)
            counts["k1_launches_in_loop"] += coupling.affine_coupling.launches - k1
            counts["rqs_launches_in_loop"] += rqs.launches - k2
            return out

        FlowProposal._device_loop_round = counted
        return self

    def __exit__(self, *exc):
        from nessai_tpu_torch.proposal.flowproposal.flowproposal import FlowProposal

        FlowProposal._device_loop_round = self._real
        return False


def phase_flagship():
    """``FLAGSHIP`` at its defaults: the device populate loop with its
    soft budget in the flow phase, the prior populated on the device and
    the nested-sampling scan chained onto both (device stepping). Fails
    unless K1 launched forward and backward, inside the loop too, and the
    scan and both device populates ran, and on a pull of 3 sigma."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    # bench.py:51-63: nlive 1000, seed 1234, RealNVP 4 x [permutation,
    # resnet affine coupling, actnorm], 100 epochs, patience 20
    with _LaunchesInLoop() as loop:
        result, nested, fs = _flagship_run(FLAGSHIP, _k1_counters())
    result.update(loop.counts, device_steps=int(getattr(fs.ns, "_n_device_steps", 0)))
    emit("flagship", **result)
    if result["k1_launches"] == 0 or result["k1_backward_launches"] == 0:
        raise RuntimeError(
            "the flagship run launched the affine-coupling kernels "
            f"{result['k1_launches']} (forward/inverse) and "
            f"{result['k1_backward_launches']} (backward) times"
        )
    _check_device_path("flagship", result, loop_kernel="k1_launches_in_loop")
    _check_run(result, nested, fs)
    return result


def _check_device_path(name, result, loop_kernel):
    """Fails unless the run took the device populate loop (launching
    ``loop_kernel`` inside it), populated the prior on the device and
    stepped through its pools with the scan kernel."""
    needed = ("device_loop_calls", "device_loop_chained_scans", "prior_device_populates", "ns_scan_launches",
              "device_steps", loop_kernel)
    missing = [k for k in needed if not result[k]]
    if missing:
        raise RuntimeError(f"{name} did not go through {missing}: {({k: result[k] for k in needed})}")


def phase_flagship_device_loop(flagship):
    """The flagship's device path, and ``FLAGSHIP`` again with
    ``device_bookkeeping=False`` (the host batched pass replays the same
    pools) and with ``batched_bookkeeping=False`` (``consume_sample`` an
    iteration at a time). Fails unless both give the flagship's logZ
    bits, iterations and insertion indices, without a scan launch."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    runs = {}
    for name, options in (("device_bookkeeping_false", dict(device_bookkeeping=False)),
                          ("batched_bookkeeping_false", dict(batched_bookkeeping=False))):
        result, nested, fs = _flagship_run(dict(FLAGSHIP, **options), _k1_counters())
        result["same_bits_as_the_flagship"] = bool(
            result["logZ"] == flagship["logZ"]
            and result["iterations"] == flagship["iterations"]
            and result["insertion_indices_sha256"] == flagship["insertion_indices_sha256"]
        )
        runs[name] = result
        _check_run(result, nested, fs)
    keys = ("logZ", "pull", "iterations", "likelihood_evaluations", "populates", "device_loop_calls",
            "device_loop_rounds", "device_loop_chunk_reads", "device_loop_chained_scans", "prior_device_populates",
            "prior_chained_scans", "ns_scan_launches", "device_steps", "k1_launches", "k1_backward_launches",
            "k1_launches_in_loop", "population_time_s", "wall_s")
    emit(
        "flagship_device_loop",
        flagship={k: flagship[k] for k in keys},
        rounds_likelihood_evaluations_before_the_device_loop=86943,
        **runs,
    )
    for name, result in runs.items():
        if not result["same_bits_as_the_flagship"]:
            raise RuntimeError(f"{name} moved the flagship: {result['logZ']} != {flagship['logZ']}")
        if result["ns_scan_launches"]:
            raise RuntimeError(f"{name} launched the scan {result['ns_scan_launches']} times")
    return runs


def phase_flagship_rounds():
    """``FLAGSHIP`` on the rounds populate (``populate_mode="rounds"``),
    the flow phase's path before the device loop was the default; the
    prior is still populated on the device. Fails on a pull of 3 sigma
    or without K1."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    result, nested, fs = _flagship_run(dict(FLAGSHIP, populate_mode="rounds"), _k1_counters())
    emit("flagship_rounds", **result)
    if result["k1_launches"] == 0 or result["device_loop_calls"]:
        raise RuntimeError(f"the rounds run launched K1 {result['k1_launches']} times, the loop "
                           f"{result['device_loop_calls']} times")
    _check_run(result, nested, fs)
    return result


def phase_flagship_fuse_likelihood_false(flagship):
    """``FLAGSHIP`` on the rounds populate with ``fuse_likelihood=False``:
    the likelihood only on the accepted pools. Fails unless the run gives
    the bits of ``flagship`` (the rounds run; the same float32 device
    likelihood, on fewer rows) with fewer likelihood evaluations and K1
    launched. (The device populate loop evaluates the pool alone
    whatever ``fuse_likelihood`` says, as the JAX package's does.)"""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    result, nested, fs = _flagship_run(dict(FLAGSHIP, populate_mode="rounds", fuse_likelihood=False),
                                       _k1_counters())
    result["fused_likelihood_evaluations"] = flagship["likelihood_evaluations"]
    result["same_logZ_bits_as_the_rounds_flagship"] = result["logZ"] == flagship["logZ"]
    emit("flagship_fuse_likelihood_false", **result)
    if not result["same_logZ_bits_as_the_rounds_flagship"] or result["iterations"] != flagship["iterations"]:
        raise RuntimeError(f"the split likelihood changed the flagship's run: {result['logZ']} {flagship['logZ']}")
    if not result["likelihood_evaluations"] < flagship["likelihood_evaluations"] or result["k1_launches"] == 0:
        raise RuntimeError(f"the split likelihood evaluated {result['likelihood_evaluations']} points")
    _check_run(result, nested, fs)
    return result


def phase_flagship_nsf():
    """``FLAGSHIP_NSF`` at its defaults, on the device populate loop: fails
    unless K2 launched forward and backward, its inverse inside the loop
    too (``flagship_nsf_device_loop``), and on a pull of 3 sigma."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_NSF

    # the same run with the neural spline flow: 4 x [permutation, resnet
    # RQS coupling with 8 bins and linear tails on [-5, 5]], no actnorm
    with _LaunchesInLoop() as loop:
        result, nested, fs = _flagship_run(FLAGSHIP_NSF, _k1_counters())
    result.update(loop.counts, device_steps=int(getattr(fs.ns, "_n_device_steps", 0)))
    emit("flagship_nsf", **result)
    emit(
        "flagship_nsf_device_loop",
        **{k: result[k] for k in ("logZ", "pull", "iterations", "likelihood_evaluations", "populates",
                                  "device_loop_calls", "device_loop_rounds", "rqs_launches_in_loop",
                                  "ns_scan_launches", "prior_device_populates", "device_steps")},
    )
    _check_device_path("flagship_nsf", result, loop_kernel="rqs_launches_in_loop")
    if result["rqs_launches"] == 0 or result["rqs_backward_launches"] == 0:
        raise RuntimeError(
            "the NSF flagship launched the spline kernels "
            f"{result['rqs_launches']} (forward/inverse) and "
            f"{result['rqs_backward_launches']} (backward) times"
        )
    _check_run(result, nested, fs)
    return result


def _k1_counters():
    """The launch counters of every kernel, K1 first, and the device
    populates' counts: (wrapper, attribute) by the name of the count."""
    from nessai_tpu_torch.ops import coupling, rqs
    from nessai_tpu_torch.utils.profiling import populate_counters

    return {
        "k1_launches": (coupling.affine_coupling, "launches"),
        "k1_backward_launches": (coupling.affine_coupling, "backward_launches"),
        "rqs_launches": (rqs, "launches"),
        "rqs_backward_launches": (rqs, "backward_launches"),
        **_rqs_unit_counters(),
        **populate_counters(),
    }


def _rqs_unit_counters():
    """The counts of K2's tails=None variant (forward and inverse, the
    inverse among them, backward) and of its backward of the inverse
    direction (all tails, then tails=None)."""
    from nessai_tpu_torch.ops import rqs

    return {
        "rqs_unit_launches": (rqs, "unit_launches"),
        "rqs_unit_inverse_launches": (rqs, "unit_inverse_launches"),
        "rqs_unit_backward_launches": (rqs, "unit_backward_launches"),
        "rqs_inverse_backward_launches": (rqs, "inverse_backward_launches"),
        "rqs_unit_inverse_backward_launches": (rqs, "unit_inverse_backward_launches"),
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
    ``examples/importance_nested_sampler/nsf_unit_hypercube.py`` (the 4-D
    Rosenbrock likelihood, a neural spline flow with tails=None on a
    uniform base) in full at ``HYPERCUBE_SMOKE_NLIVE`` live points. Fails unless
    |pull| < 3 against the quadrature's log-evidence with the sampler's
    own error, the samples lie in [-5, 5]^4, and K2's tails=None variant
    launched forward, inverse and backward."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_HYPERCUBE, phase_times
    from nessai_tpu_torch.utils.testing import RosenbrockModel, rosenbrock_log_evidence

    # the transfer-matrix quadrature: -15.1016907 at 4001, 8001 and 16001 points
    analytic = rosenbrock_log_evidence(4, n=8001)
    config = dict(FLAGSHIP_INS_HYPERCUBE, nlive=HYPERCUBE_SMOKE_NLIVE)
    fs, model, samples, wall, launches = _drive(config, _k1_counters(), model=RosenbrockModel(4))
    ns = fs.ns
    err = float(fs.logZ_error)
    pull = (fs.logZ - analytic) / err
    times = phase_times(fs)
    result = dict(
        nlive=HYPERCUBE_SMOKE_NLIVE,
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


def _virtual_mesh():
    from nessai_tpu_torch.parallel import get_mesh

    return get_mesh(devices=list(VIRTUAL_MESH_DEVICES))


def _dp_step_case(config, mesh, kernel, seed):
    """One data-parallel Adam step of ``config``'s flow on ``mesh``
    against one single-device step of the same flow on the same batch of
    ``MESH_DP_ROWS`` rows; ``kernel`` is the count (``k1`` or ``rqs``) that
    must be the replicas' number times the single-device count."""
    import copy

    from nessai_tpu_torch.parallel import make_dp_train_step

    counters = _k1_counters()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    single = _flagship_flow("cuda", config, seed=seed)
    with torch.no_grad():
        # weights off the identity, as in a trained flow
        for p in single.parameters():
            p.add_(0.05 * torch.randn(p.shape, device="cuda", generator=gen))
    dp = copy.deepcopy(single)
    x = torch.randn(MESH_DP_ROWS, 2, device="cuda", generator=gen)
    opt_single = torch.optim.Adam(single.parameters(), lr=1e-3)
    opt_dp = torch.optim.Adam(dp.parameters(), lr=1e-3)
    step = make_dp_train_step(dp, opt_dp, mesh)

    def counted(fn):
        for wrapper, attr in counters.values():
            setattr(wrapper, attr, 0)
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, {k: int(getattr(w, a)) for k, (w, a) in counters.items()}

    def single_step():
        opt_single.zero_grad(set_to_none=True)
        loss = -single.log_prob(x).mean()
        loss.backward()
        opt_single.step()
        return loss.detach()

    loss_single, single_s, launches_single = counted(single_step)
    loss_dp, dp_s, launches_dp = counted(lambda: step(x))
    param_err = max((a - b).abs().max().item() for a, b in zip(single.parameters(), dp.parameters(), strict=True))
    # the optimiser step leaves the summed gradient in the primary's .grad
    grad_share = max(
        (a.grad - b.grad).abs().max().item() / max(a.grad.abs().max().item(), 1e-30)
        for a, b in zip(single.parameters(), dp.parameters(), strict=True)
        if a.grad is not None
    )
    replica_err = max(
        (
            (a - b.to(a.device)).abs().max().item()
            for replica in step.replicas[1:]
            for a, b in zip(dp.parameters(), replica.parameters(), strict=True)
        ),
        default=0.0,
    )
    result = dict(
        replicas=mesh.size,
        devices=[str(d) for d in mesh.devices],
        loss_single=float(loss_single),
        loss_dp=float(loss_dp),
        max_param_err=param_err,
        max_grad_err_share=grad_share,
        max_replica_err=replica_err,
        single_step_s=single_s,
        dp_step_s=dp_s,
        launches_single={k: launches_single[k] for k in (f"{kernel}_launches", f"{kernel}_backward_launches")},
        launches_dp={k: launches_dp[k] for k in (f"{kernel}_launches", f"{kernel}_backward_launches")},
    )
    if not abs(result["loss_dp"] - result["loss_single"]) <= MESH_DP_LOSS_RTOL * abs(result["loss_single"]):
        raise RuntimeError(f"data-parallel loss {result['loss_dp']} against {result['loss_single']}")
    if not grad_share <= MESH_DP_GRAD_RTOL:
        raise RuntimeError(f"data-parallel gradient {grad_share} of the largest single-device gradient away")
    if not param_err <= MESH_DP_PARAM_ATOL or replica_err != 0.0:
        raise RuntimeError(f"data-parallel step: parameters {param_err} from the single step, replicas {replica_err}")
    for key, count in result["launches_single"].items():
        if not count or result["launches_dp"][key] != mesh.size * count:
            raise RuntimeError(f"{key}: {result['launches_dp'][key]} on {mesh.size} replicas, {count} on one device")
    return result


def phase_mesh_dp_step():
    """``make_dp_train_step`` on the virtual mesh (two replicas on
    ``cuda:0``) and on ``get_mesh()`` (every GPU), for the RealNVP and the
    NSF flagship's flows: the loss, the summed gradient and every
    parameter after one Adam step against the single-device step
    (``MESH_DP_LOSS_RTOL``, ``MESH_DP_GRAD_RTOL``,
    ``MESH_DP_PARAM_ATOL``), the replicas equal to the primary after it,
    and K1 (K2) launched the replicas' number times the single-device
    count."""
    from nessai_tpu_torch.parallel import get_mesh
    from nessai_tpu_torch.utils.profiling import FLAGSHIP, FLAGSHIP_NSF

    cases = {}
    for mesh_name, mesh in (("virtual", _virtual_mesh()), ("get_mesh", get_mesh())):
        for flow_name, config, kernel in (("realnvp", FLAGSHIP, "k1"), ("nsf", FLAGSHIP_NSF, "rqs")):
            cases[f"{flow_name}_{mesh_name}"] = _dp_step_case(config, mesh, kernel, seed=len(cases) + 1)
    tolerance = {"loss_rtol": MESH_DP_LOSS_RTOL, "grad_rtol_of_max": MESH_DP_GRAD_RTOL, "param_atol": MESH_DP_PARAM_ATOL}
    emit("mesh_dp_step", tolerance=tolerance,
         rows=MESH_DP_ROWS, **cases)
    return cases


class _CountTrainingSteps:
    """Counts ``FlowModel._train_step`` calls while it is entered, and
    those taken on a mesh."""

    def __enter__(self):
        from nessai_tpu_torch.flowmodel.base import FlowModel

        self.steps = self.mesh_steps = 0
        self._original = FlowModel._train_step
        counter = self

        def counted(model, *args, **kwargs):
            counter.steps += 1
            counter.mesh_steps += model.mesh is not None
            return counter._original(model, *args, **kwargs)

        FlowModel._train_step = counted
        return self

    def __exit__(self, *exc):
        from nessai_tpu_torch.flowmodel.base import FlowModel

        FlowModel._train_step = self._original


def phase_flagship_mesh(flagship):
    """``FLAGSHIP`` with ``mesh`` the virtual mesh: the device populate
    loop is off (the rounds populate, its device call cut over the
    mesh) and every training step is data-parallel. Fails unless the run
    made no device-loop call, every training step was on the mesh with K1
    backward launched once a coupling on each replica, and on a pull of 3
    sigma. Prints its wall, training share, populates and trainings beside
    the single-device flagship's."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    mesh = _virtual_mesh()
    with _CountTrainingSteps() as steps:
        result, nested, fs = _flagship_run(dict(FLAGSHIP, mesh=mesh), _k1_counters())
    flow = fs.ns.flow_proposal.flow
    couplings = sum(type(b).__name__ == "AffineCoupling" for b in flow.flow.bijector.bijectors)
    result.update(
        replicas=mesh.size,
        devices=[str(d) for d in mesh.devices],
        training_steps=steps.steps,
        mesh_training_steps=steps.mesh_steps,
        couplings=couplings,
        training_share=result["training_time_s"] / result["wall_s"],
        can_device_loop=bool(fs.ns.flow_proposal._can_device_loop),
        single_device={k: flagship[k] for k in ("logZ", "pull", "wall_s", "training_time_s", "populates",
                                                 "trainings", "population_time_s", "k1_launches",
                                                 "k1_backward_launches")},
    )
    result["single_device"]["training_share"] = flagship["training_time_s"] / flagship["wall_s"]
    emit("flagship_mesh", **result)
    if result["device_loop_calls"] or result["can_device_loop"]:
        raise RuntimeError(f"the mesh run called the device populate loop {result['device_loop_calls']} times")
    if not steps.steps or steps.mesh_steps != steps.steps:
        raise RuntimeError(f"{steps.mesh_steps} of {steps.steps} training steps were on the mesh")
    if result["k1_backward_launches"] != mesh.size * couplings * steps.steps:
        raise RuntimeError(
            f"K1 backward launched {result['k1_backward_launches']} times in {steps.steps} steps of "
            f"{couplings} couplings on {mesh.size} replicas"
        )
    _check_run(result, nested, fs)
    return result


def phase_flagship_ins_mesh(flagship_ins):
    """``FLAGSHIP_INS`` with ``mesh`` the virtual mesh: every level trains
    data-parallel and ``log_prob_all`` cuts its rows over the mesh. Fails
    on a pull of 3 sigma, unless every ``log_prob_all`` call and every
    training step was on the mesh."""
    from nessai_tpu_torch.flowmodel.importance import ImportanceFlowModel
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS, phase_times

    mesh = _virtual_mesh()
    calls = {"log_prob_all": 0, "sharded": 0}
    original = ImportanceFlowModel.log_prob_all

    def counted(model, x):
        calls["log_prob_all"] += 1
        calls["sharded"] += model.mesh is not None and model.n_models > 0
        return original(model, x)

    ImportanceFlowModel.log_prob_all = counted
    try:
        with _CountTrainingSteps() as steps:
            fs, model, samples, wall, launches = _drive(dict(FLAGSHIP_INS, mesh=mesh), _k1_counters())
    finally:
        ImportanceFlowModel.log_prob_all = original
    ns = fs.ns
    analytic = float(model.analytic_log_evidence)
    err = float(fs.logZ_error)
    pull = (fs.logZ - analytic) / err
    times = phase_times(fs)
    result = dict(
        logZ=fs.logZ,
        logZ_err=err,
        analytic=analytic,
        pull=pull,
        replicas=mesh.size,
        iterations=int(ns.iteration),
        samples=int(len(samples)),
        wall_s=wall,
        **times,
        training_share=times["training_time_s"] / wall,
        training_steps=steps.steps,
        mesh_training_steps=steps.mesh_steps,
        log_prob_all_calls=calls["log_prob_all"],
        log_prob_all_sharded=calls["sharded"],
        **launches,
        single_device={k: flagship_ins[k] for k in ("logZ", "pull", "wall_s", "training_time_s", "levels",
                                                     "log_prob_all_time_s", "k1_launches")},
    )
    emit("flagship_ins_mesh", **result)
    if not math.isfinite(pull) or abs(pull) >= PULL_LIMIT:
        raise RuntimeError(f"INS logZ pull {pull} on the mesh is not within {PULL_LIMIT} sigma")
    if not calls["sharded"] or steps.mesh_steps != steps.steps or not steps.steps:
        raise RuntimeError(f"on the mesh: log_prob_all {calls}, training steps {steps.mesh_steps} of {steps.steps}")
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
    (``FLAGSHIP_INS_MIXTURE``: the ratio and ESS criteria, then the final
    redraw) in full on the GPU, at ``MIXTURE_SMOKE``'s live points, ESS
    and redraw ESS (the example's 2000, 3000 and 2000 cut for the
    script's time)."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_INS_MIXTURE, FLAGSHIP_INS_MIXTURE_RUN, phase_times
    from nessai_tpu_torch.utils.stats import effective_sample_size
    from nessai_tpu_torch.utils.testing import GaussianMixture

    run_kwargs = dict(FLAGSHIP_INS_MIXTURE_RUN, n_posterior_samples=MIXTURE_SMOKE["n_posterior_samples"])
    n_post = run_kwargs["n_posterior_samples"]
    sampler_log = logging.getLogger("nessai_tpu_torch.samplers.importancesampler")
    messages = _Messages()
    sampler_log.addHandler(messages)
    try:
        config = dict(FLAGSHIP_INS_MIXTURE, nlive=MIXTURE_SMOKE["nlive"],
                      tolerance=[FLAGSHIP_INS_MIXTURE["tolerance"][0], MIXTURE_SMOKE["ess"]])
        fs, model, samples, wall, launches = _drive(
            config, _k1_counters(), model=GaussianMixture(2), run_kwargs=run_kwargs
        )
    finally:
        sampler_log.removeHandler(messages)
    ns = fs.ns
    analytic = float(model.analytic_log_evidence)
    stopped_at_ratio = any("maximum number of redraw samples" in m for m in messages.messages)
    redraw_ess = float(effective_sample_size(ns.final_log_w))
    times = phase_times(fs)
    result = dict(
        **MIXTURE_SMOKE,
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
#: past this script's time limit. Here it stops at this iteration: past
#: the 9th training (at iteration 8939 on the H100), so the reset before
#: it is checked, about 11 s (to 12,000 it took 36 trainings and 91-145
#: s, the trainings after the 16th most of it; PERF.md);
#: ``python3 chip_smoke.py --eggbox-in-full`` runs it to its end with the
#: same checks and the pull's gate.
EGGBOX_SMOKE_ITERATIONS = 9_000
#: the egg-box's numbers on the rounds populate with the hard 1e6 cap
#: (PERF.md §5, H100 80GB HBM3 at 700 W), reported beside this run's
#: under the device populate loop's soft budget: to 12,000 iterations
#: and in full
EGGBOX_ROUNDS_POPULATE = {
    12_000: dict(trainings=18, population_time_s=8.179491, likelihood_evaluations=9_380_683),
    None: dict(trainings=699, population_time_s=229.731533, likelihood_evaluations=304_669_073,
               wall_s=2605.004081696),
}


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
        on_the_rounds_populate=EGGBOX_ROUNDS_POPULATE.get(max_iteration),
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


def phase_flagship_mcmc():
    """``FLAGSHIP_MCMC``, ``examples/mcmc_example.py`` as written (the MCMC
    flow proposal, 20 differential-evolution steps a populate, nlive 2000,
    seed 1234, a host likelihood), in full: each step one flow inverse of
    the whole pool on the GPU. Fails unless |pull| < 3 against -log 400,
    K1 launched forward and backward, and every pool point of every
    populate lies in the prior bounds."""
    from nessai_tpu_torch.experimental.proposal import MCMCFlowProposal
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_MCMC
    from nessai_tpu_torch.utils.testing import GaussianModel

    pools = []
    real = MCMCFlowProposal.populate

    def checked(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        pools.append((len(self.samples), _in_bounds(self.samples, self.model)))
        return out

    MCMCFlowProposal.populate = checked
    try:
        fs, model, nested, wall, launches = _drive(FLAGSHIP_MCMC, _k1_counters(), model=GaussianModel())
    finally:
        MCMCFlowProposal.populate = real
    result = _standard_result(fs, model, wall, launches, float(model.analytic_log_evidence))
    proposal = fs.ns.flow_proposal
    result.update(
        proposal=type(proposal).__name__,
        step_type=proposal.step_type,
        n_steps=proposal.n_steps,
        mcmc_history=proposal.mcmc_history,
        pool_sizes=[n for n, _ in pools],
        every_pool_in_bounds=bool(pools) and all(ok for _, ok in pools),
    )
    emit("flagship_mcmc", **result)
    _check_standard("flagship_mcmc", result, nested, fs, model)
    if not result["every_pool_in_bounds"]:
        raise RuntimeError(f"an MCMC pool left the prior bounds: {pools}")
    return result


def phase_flagship_clustering():
    """``FLAGSHIP_CLUSTERING``: the RealNVP flagship with the clustering
    flow proposal (8 clusters at most), in full. Every coupling's net
    takes the one-hot label; the populate takes the rounds through the
    proposal's backward pass, never the device loop, and the sampler
    steps through the flow phase's pools on the host (the scan may run in
    the uninformed phase, chained onto the prior's device populate).
    Fails unless |pull| < 3, some training chose two clusters or more, K1
    launched forward and backward, and the device loop was not called."""
    from nessai_tpu_torch.experimental.flowmodel import ClusteringFlowModel
    from nessai_tpu_torch.utils.profiling import FLAGSHIP_CLUSTERING

    chosen = []
    real = ClusteringFlowModel.train_clustering

    def recording(self, samples):
        out = real(self, samples)
        chosen.append(self.n_clusters)
        return out

    ClusteringFlowModel.train_clustering = recording
    try:
        with _LaunchesInLoop() as loop:
            fs, model, nested, wall, launches = _drive(FLAGSHIP_CLUSTERING, _k1_counters())
    finally:
        ClusteringFlowModel.train_clustering = real
    result = _standard_result(fs, model, wall, launches, float(model.analytic_log_evidence))
    flow = fs.ns.flow_proposal.flow
    couplings = [b for b in flow.flow.bijector.bijectors if hasattr(b, "net")]
    result.update(
        loop.counts,
        proposal=type(fs.ns.flow_proposal).__name__,
        clusters_chosen=chosen,
        last_cluster_weights=np.asarray(flow.cluster_weights).tolist(),
        conditioner_inputs=[c.net.initial.in_features for c in couplings],
        uninformed_population_time_s=fs.ns._uninformed_proposal.population_time.total_seconds(),
        device_steps=int(getattr(fs.ns, "_n_device_steps", 0)),
    )
    emit("flagship_clustering", **result)
    _check_standard("flagship_clustering", result, nested, fs, model)
    if not any(k >= 2 for k in chosen):
        raise RuntimeError(f"no training of the clustering run chose two clusters or more: {chosen}")
    if result["device_loop_calls"] or result["k1_launches_in_loop"]:
        raise RuntimeError(f"the clustering run called the device populate loop {result['device_loop_calls']} times")
    if result["conditioner_inputs"] != [1 + flow.max_clusters] * len(couplings):
        raise RuntimeError(f"the couplings' nets take {result['conditioner_inputs']} inputs, not x_id and the label")
    return result


# ---------------------------------------------------------------------------
# The GW examples (nessai_tpu_torch/examples/gw, the scripts of examples/gw)
# ---------------------------------------------------------------------------
#: the JAX package's logZ of each GW example's configuration as its script
#: runs it, measured on a CPU (the JAX package does not run on the card)
#: by ``tools/gw_jax_reference.py`` (the script's arguments, plots and
#: checkpoints off) under JAX 0.9.0 on an Intel Xeon, two threads a run,
#: at commit 1d1badc; seconds of that run. The port's run is held to it by
#: the pull (logZ - logZ_jax) / sqrt(sigma^2 + sigma_jax^2).
GW_JAX_CPU_LOGZ = {
    "gw_basic": dict(logZ=-1830.3832506048425, sigma=0.08621499854964289, seconds=127.7, seed=170817),
    "gw_callback": dict(logZ=-1830.2458983322867, sigma=0.08547107479660952, seconds=70.6, seed=170817),
    "gw_ins": dict(logZ=-1830.3978474974801, sigma=0.019076774793770256, seconds=85.7, seed=151226,
                   sampler_logZ=-1830.4147139398724),
    "gw_toy_cbc": dict(logZ=-544.1221306848776, sigma=0.10270889907629788, seconds=339.2, seed=1234),
    "gw_calibration": dict(logZ=-1889.4548254264284, sigma=0.07785369142809336, seconds=187.6, seed=150914),
    "gw_full": dict(logZ=-1886.9923251386817, sigma=0.032386603735617914, seconds=3067.9, seed=150914),
}
GW_JAX_CPU_PROVENANCE = "tools/gw_jax_reference.py: JAX 0.9.0 on an Intel Xeon CPU, 2 threads a run, commit 1d1badc"
#: the device likelihood on the card against the host's float64 one, as the
#: JAX package's own test holds its float32 likelihood
#: (tests/test_gw_example.py:60-64)
GW_LIKELIHOOD_RTOL = 1e-4
GW_LIKELIHOOD_ROWS = 4096
#: iteration caps of the wider GW runs in the script (None runs to the end,
#: as ``--gw-in-full`` does): each stops after its third training, two
#: past the one that ends the uninformed phase (on the H100 the full model
#: trained at iterations 5998, 6208 and 6704, the toy at 5543, 7155 and
#: 8076, the calibration model at 2822, 2986 and 3374); the full model's
#: cap is ``utils.profiling.GW_FULL_PROFILE_ITERATIONS``, where its profile
#: stops too
GW_SMOKE_ITERATIONS = {"gw_toy_cbc": 8100, "gw_calibration": 3500}
#: the injected parameters that must lie inside the posterior's quantiles
GW_QUANTILES = (0.001, 0.999)


def _gw_module(name):
    import importlib

    return importlib.import_module(f"nessai_tpu_torch.examples.gw.{name}")


class _K1Widths:
    """Counts K1's forward and backward launches by the layer's width D
    while it is entered."""

    def __enter__(self):
        from nessai_tpu_torch.ops import coupling

        self.counts = {}
        self._real = (coupling._forward, coupling._backward)
        counts = self.counts
        forward, backward = self._real

        def counted_forward(x, *args, **kwargs):
            counts.setdefault(int(x.shape[1]), [0, 0])[0] += 1
            return forward(x, *args, **kwargs)

        def counted_backward(x, *args, **kwargs):
            counts.setdefault(int(x.shape[1]), [0, 0])[1] += 1
            return backward(x, *args, **kwargs)

        coupling._forward, coupling._backward = counted_forward, counted_backward
        return self

    def __exit__(self, *exc):
        from nessai_tpu_torch.ops import coupling

        coupling._forward, coupling._backward = self._real
        return False


def phase_gw_likelihood(smi):
    """``gw_likelihood_gpu_vs_host``: each GW model's device likelihood
    (toy, basic, full, calibration) on ``GW_LIKELIHOOD_ROWS`` prior draws
    on the card against its float64 host likelihood, to
    ``GW_LIKELIHOOD_RTOL``; the GPU time a call (CUDA events)."""
    rows = {}
    for name, cls in (("toy_cbc", "ToyCBCModel"), ("basic_gw_example", "BasicGWModel"),
                      ("full_gw_example", "FullGWModel"), ("calibration_example", "CalibratedGWModel")):
        model = getattr(_gw_module(name), cls)()
        model.device = "cuda"
        model.set_rng(np.random.default_rng(20261018))
        x = model.new_point(GW_LIKELIHOOD_ROWS)
        host = model.log_likelihood(x)
        fn, data = model.device_log_likelihood_fn("cuda")
        arr = torch.as_tensor(np.stack([x[n] for n in model.names], axis=1), dtype=torch.float32, device="cuda")
        with torch.no_grad():
            dev = fn(arr, data).double().cpu().numpy()
            ms = time_ms(lambda: fn(arr, data), inner=10, repeats=10)
        rel = float(np.max(np.abs(dev - host) / np.abs(host)))
        rows[name] = dict(dims=model.dims, rows=GW_LIKELIHOOD_ROWS, max_rel_err=rel, ms=ms,
                          data_bytes=int(sum(np.asarray(v).nbytes for v in model.torch_likelihood_data.values())),
                          finite=bool(np.all(np.isfinite(dev))))
    emit("gw_likelihood_gpu_vs_host", card=smi, rtol=GW_LIKELIHOOD_RTOL,
         reference="the model's float64 numpy log_likelihood on the host", timer="CUDA events, median of 10 x 10 calls",
         models=rows)
    bad = {k: r for k, r in rows.items() if not r["finite"] or r["max_rel_err"] > GW_LIKELIHOOD_RTOL}
    if bad:
        raise RuntimeError(f"GW device likelihoods off the host's: {bad}")
    return rows


def _pull(logZ, sigma, reference, reference_sigma):
    return (logZ - reference) / math.sqrt(sigma**2 + reference_sigma**2)


def _gw_run(module, cls, max_iteration=None):
    """One run of a GW example's model with its script's arguments on the
    card, to ``max_iteration``; the summary with the counters, the K1
    launches by width, the device populate's counts and the scan's
    launches."""
    m = _gw_module(module)
    kwargs = dict(m.SAMPLER_KWARGS, resume=False, plot=False, checkpointing=False)
    if max_iteration is not None:
        kwargs["max_iteration"] = max_iteration
    with _K1Widths() as widths:
        fs, model, nested, wall, launches = _drive(kwargs, _k1_counters(), model=getattr(m, cls)())
    result = _standard_result(fs, model, wall, launches, None)
    proposal = fs.ns.flow_proposal
    reasons = []
    if not result["device_loop_calls"]:
        reasons = [r for r, bad in (
            ("no device inverse", not proposal.uses_device_inverse),
            ("a prior that is neither a uniform box nor a torch_log_prior",
             not (model.has_torch_prior or model.has_uniform_box_prior)),
            ("a mesh", proposal.flow.mesh is not None),
        ) if bad] or ["populate_mode or the truncation rules"]
    result.update(
        max_iteration=max_iteration,
        k1_launches_by_width={str(k): v for k, v in sorted(widths.counts.items())},
        flow_dims=len(proposal.prime_parameters),
        prime_parameters=list(proposal.prime_parameters),
        reparameterisations={k: type(r).__name__ for k, r in proposal._reparameterisation.items()},
        device_loop_off_because=reasons,
        device_steps=int(getattr(fs.ns, "_n_device_steps", 0)),
        training_iterations=[int(i) for i in fs.ns.training_iterations],
        uninformed_population_time_s=fs.ns._uninformed_proposal.population_time.total_seconds(),
        likelihood_callback=bool(model.likelihood_callback),
        has_torch_likelihood=bool(model.has_torch_likelihood),
    )
    live = fs.ns.live_points
    host = model.log_likelihood(live)
    result["live_logL_max_rel_err_vs_host"] = float(np.max(np.abs(live["logL"] - host) / np.abs(host)))
    return result, nested, fs, model


def _gw_check(name, result, nested, fs, model, dims=None):
    """K1 forward and backward launched (at the flow's width ``dims``),
    samples in bounds, the live points' stored logL the host's to
    ``GW_LIKELIHOOD_RTOL``; the pull's gate where a reference is given."""
    _check_standard(name, result, nested, fs, model)
    if dims is not None and not all(result["k1_launches_by_width"].get(str(dims), [0, 0])):
        raise RuntimeError(f"{name} launched no K1 at D = {dims}: {result['k1_launches_by_width']}")
    if not result["live_logL_max_rel_err_vs_host"] <= GW_LIKELIHOOD_RTOL:
        raise RuntimeError(f"{name}: live logL off the host's by {result['live_logL_max_rel_err_vs_host']}")
    pull = result.get("pull_vs_jax_cpu")
    if result["max_iteration"] is None and name in GW_JAX_CPU_LOGZ:
        if pull is None or not math.isfinite(pull) or abs(pull) >= PULL_LIMIT:
            raise RuntimeError(f"{name} logZ pull {pull} against the JAX package is not within {PULL_LIMIT} sigma")


def _with_jax_pull(name, result):
    ref = GW_JAX_CPU_LOGZ.get(name)
    if ref is not None:
        result.update(jax_cpu_logZ=ref["logZ"], jax_cpu_logZ_err=ref["sigma"], jax_cpu_seconds=ref["seconds"],
                      jax_cpu_from=GW_JAX_CPU_PROVENANCE,
                      pull_vs_jax_cpu=_pull(result["logZ"], result["logZ_err"], ref["logZ"], ref["sigma"]))
    return result


def phase_gw_basic():
    """``gw_basic``: ``examples/gw/basic_gw_example.py`` as written (nlive
    1000, seed 170817, angle-2pi on the phase, the data through
    ``torch_likelihood_data``), in full. Fails unless |pull| < 3 against
    the JAX package's logZ (``GW_JAX_CPU_LOGZ``), the injected chirp mass
    and distance lie inside the posterior's 0.1-99.9% quantiles, the
    samples are in bounds, K1 launched forward and backward at D = 5 and
    the scan launched (the device populate loop and the prior's device
    populate)."""
    m = _gw_module("basic_gw_example")
    result, nested, fs, model = _gw_run("basic_gw_example", "BasicGWModel")
    _with_jax_pull("gw_basic", result)
    post = fs.posterior_samples
    inside = {}
    for p in ("chirp_mass", "luminosity_distance"):
        lo, hi = np.quantile(post[p], GW_QUANTILES)
        inside[p] = dict(true=m.TRUE[p], quantiles=[float(lo), float(hi)], inside=bool(lo <= m.TRUE[p] <= hi))
    result.update(injection_inside_posterior=inside)
    emit("gw_basic", **result)
    _gw_check("gw_basic", result, nested, fs, model, dims=5)
    if not all(v["inside"] for v in inside.values()):
        raise RuntimeError(f"gw_basic: an injected value lies outside the posterior's quantiles: {inside}")
    _check_device_path("gw_basic", result, loop_kernel="k1_launches")
    return result


def phase_gw_callback(basic):
    """``gw_callback``: ``examples/gw/callback_gw_example.py`` as written
    (the host numpy likelihood with ``likelihood_callback``, nlive 1000,
    seed 170817), in full. Fails unless |pull| < 3 against ``gw_basic``'s
    logZ (the same data and likelihood, here in float64 on the host),
    the callback stands in for the device likelihood, never on rejected
    draws, and the scan never launched (the chain needs a device
    likelihood, as in the JAX package)."""
    result, nested, fs, model = _gw_run("callback_gw_example", "LalStyleGWModel")
    _with_jax_pull("gw_callback", result)
    proposal = fs.ns.flow_proposal
    result.update(
        pull_vs_gw_basic=_pull(result["logZ"], result["logZ_err"], basic["logZ"], basic["logZ_err"]),
        callback_is_the_device_likelihood=model.get_device_log_likelihood("cuda") is not None,
        callback_on_rejected_draws=bool(proposal._resolve_fuse_likelihood()),
    )
    emit("gw_callback", **result)
    _gw_check("gw_callback", result, nested, fs, model)
    if abs(result["pull_vs_gw_basic"]) >= PULL_LIMIT:
        raise RuntimeError(f"gw_callback's logZ is {result['pull_vs_gw_basic']} sigma from gw_basic's")
    if not (result["likelihood_callback"] and not result["has_torch_likelihood"]
            and result["callback_is_the_device_likelihood"] and not result["callback_on_rejected_draws"]):
        raise RuntimeError(f"gw_callback's likelihood callback is not in effect: {result}")
    if result["ns_scan_launches"] or result["prior_device_populates"]:
        raise RuntimeError(f"gw_callback launched the scan {result['ns_scan_launches']} times")
    return result


#: ``gw_ins`` in full took 229.8 s on the card (28 levels; PERF.md), over
#: the 60 s the script allows it, so the script stops it after this many
#: levels, without the redraw; ``--gw-in-full`` runs it as written
GW_INS_SMOKE_LEVELS = 4


def phase_gw_ins(basic=None, max_iteration=GW_INS_SMOKE_LEVELS):
    """``gw_ins``: ``examples/gw/ins_gw_example.py`` (the importance
    nested sampler on the basic model, nlive 2000, seed 151226), to
    ``max_iteration`` levels. Fails unless logZ is finite, K1 launched
    forward and backward, every ``log_prob_all`` covered every level and
    the samples lie in bounds. Run as written (``max_iteration=None``: to
    its end, then the final redraw to 2000 samples) it also fails unless
    |pull| < 3 against the JAX package's logZ and ``basic``'s (where
    given) and the redraw's ESS is at least 2000 (or stopped at
    ``max_samples_ratio``)."""
    from nessai_tpu_torch.flowmodel.importance import ImportanceFlowModel
    from nessai_tpu_torch.utils.profiling import phase_times
    from nessai_tpu_torch.utils.stats import effective_sample_size

    m = _gw_module("ins_gw_example")
    in_full = max_iteration is None
    levels_seen = []
    real = ImportanceFlowModel.log_prob_all

    def recording(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        levels_seen.append((int(np.asarray(out).shape[-1]), int(self.n_models)))
        return out

    sampler_log = logging.getLogger("nessai_tpu_torch.samplers.importancesampler")
    messages = _Messages()
    sampler_log.addHandler(messages)
    ImportanceFlowModel.log_prob_all = recording
    try:
        config = dict(m.SAMPLER_KWARGS, resume=False, plot=False, checkpointing=False)
        if not in_full:
            config["max_iteration"] = max_iteration
        fs, model, samples, wall, launches = _drive(config, _k1_counters(), model=m.BasicGWModel(),
                                                    run_kwargs=m.RUN_KWARGS if in_full else None)
    finally:
        ImportanceFlowModel.log_prob_all = real
        sampler_log.removeHandler(messages)
    ns = fs.ns
    times = phase_times(fs)
    result = dict(
        max_iteration=max_iteration,
        levels=times.pop("levels"),
        samples=int(len(samples)),
        # the sampler's own estimate, before the redraw where there is one
        sampler_logZ=fs.initial_logZ if in_full else fs.logZ,
        sampler_logZ_err=fs.initial_logZ_error if in_full else fs.logZ_error,
        logZ=fs.logZ,
        logZ_err=fs.logZ_error,
        log_prob_all_calls=len(levels_seen),
        wall_s=wall,
        **times,
        likelihood_evaluations=int(model.likelihood_evaluations),
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    pulls = []
    if in_full:
        n_post = m.RUN_KWARGS["n_posterior_samples"]
        result.update(
            redraw_ess=float(effective_sample_size(ns.final_log_w)),
            redraw_stopped_at_max_samples_ratio=any(
                "maximum number of redraw samples" in msg for msg in messages.messages
            ),
        )
        _with_jax_pull("gw_ins", result)
        pulls.append("pull_vs_jax_cpu")
        if basic is not None:
            result["pull_vs_gw_basic"] = _pull(fs.logZ, fs.logZ_error, basic["logZ"], basic["logZ_err"])
            pulls.append("pull_vs_gw_basic")
    emit("gw_ins", **result)
    if launches["k1_launches"] == 0 or launches["k1_backward_launches"] == 0:
        raise RuntimeError(f"gw_ins launched K1 {launches}")
    if not math.isfinite(result["logZ"]):
        raise RuntimeError(f"gw_ins logZ {result['logZ']}")
    for key in pulls:
        if not math.isfinite(result[key]) or abs(result[key]) >= PULL_LIMIT:
            raise RuntimeError(f"gw_ins {key} {result[key]} is not within {PULL_LIMIT} sigma")
    if not levels_seen or any(cols != n for cols, n in levels_seen):
        raise RuntimeError(f"gw_ins: a log_prob_all call missed a level: {levels_seen}")
    if not _in_bounds(samples, model) or not _in_bounds(fs.posterior_samples, model):
        raise RuntimeError("gw_ins: samples are empty, not finite or out of bounds")
    if in_full and result["redraw_ess"] < n_post and not result["redraw_stopped_at_max_samples_ratio"]:
        raise RuntimeError(f"gw_ins: the redraw's ESS {result['redraw_ess']} is below {n_post}")
    return result


def phase_gw_full(max_iteration):
    """``gw_full``: ``examples/gw/full_gw_example.py`` at full width (9
    parameters, angle-2pi on the phase, angle-pi on psi, the angle pair on
    (ra, dec): 12 prime dimensions; a 6 x 32 RealNVP; nlive 2000), to
    ``max_iteration`` (None: to its end, with the pull's gate). Fails
    unless the angle pair's three prime parameters and both angle
    reparameterisations are in the stack, K1 launched forward and backward
    at D = 12, the live points' logL are the host's, ra and dec stay in
    their ranges and the samples in bounds."""
    result, nested, fs, model = _gw_run("full_gw_example", "FullGWModel", max_iteration=max_iteration)
    _with_jax_pull("gw_full", result)
    post = fs.posterior_samples
    ra = np.concatenate([nested["ra"], post["ra"]])
    dec = np.concatenate([nested["dec"], post["dec"]])
    result.update(
        trainings_after_the_uninformed_phase=result["trainings"] - 1,
        ra_range=[float(ra.min()), float(ra.max())],
        dec_range=[float(dec.min()), float(dec.max())],
    )
    emit("gw_full", **result)
    _gw_check("gw_full", result, nested, fs, model, dims=12)
    prime = set(result["prime_parameters"])
    kinds = sorted(result["reparameterisations"].values())
    if not {"ra_x", "ra_y", "ra_z"} <= prime or result["flow_dims"] != 12:
        raise RuntimeError(f"gw_full: the angle pair's prime parameters are missing: {result['prime_parameters']}")
    if not {"AnglePair", "Angle"} <= set(kinds) or sum(k == "Angle" for k in kinds) < 2:
        raise RuntimeError(f"gw_full: the stack is {result['reparameterisations']}")
    if not (ra.min() >= 0.0 and ra.max() <= 2 * np.pi and dec.min() >= -np.pi / 2 and dec.max() <= np.pi / 2):
        raise RuntimeError(f"gw_full: ra {result['ra_range']} or dec {result['dec_range']} out of range")
    if max_iteration is not None and result["trainings"] < 3:
        raise RuntimeError(f"gw_full stopped after {result['trainings']} trainings")
    return result


def phase_gw_toy_cbc(max_iteration=GW_SMOKE_ITERATIONS["gw_toy_cbc"]):
    """``gw_toy_cbc``: ``examples/gw/toy_cbc.py`` at full width (5
    parameters, angle-2pi on phi0: D = 6; nlive 2000, seed 1234), to
    ``max_iteration`` (None: to its end, with the pull's gate). Fails
    unless K1 launched at D = 6, the live points' logL are the host's and
    the samples are in bounds."""
    result, nested, fs, model = _gw_run("toy_cbc", "ToyCBCModel", max_iteration=max_iteration)
    _with_jax_pull("gw_toy_cbc", result)
    emit("gw_toy_cbc", **result)
    _gw_check("gw_toy_cbc", result, nested, fs, model, dims=6)
    return result


def phase_gw_calibration(max_iteration=GW_SMOKE_ITERATIONS["gw_calibration"]):
    """``gw_calibration``: ``examples/gw/calibration_example.py`` at full
    width (4 source parameters and 6 calibration nodes with a truncated
    Gaussian host prior, angle-2pi on the phase: D = 11; a 6 x 32 RealNVP;
    nlive 1000), to ``max_iteration`` (None: to its end, with the pull's
    gate). The non-box host prior keeps it on the rounds populate with the
    prior on the host, as in the JAX package. Fails unless K1 launched at
    D = 11, the device populate loop and the prior's device populate did
    not run, the live points' logL are the host's and the samples are in
    bounds."""
    result, nested, fs, model = _gw_run("calibration_example", "CalibratedGWModel", max_iteration=max_iteration)
    _with_jax_pull("gw_calibration", result)
    emit("gw_calibration", **result)
    _gw_check("gw_calibration", result, nested, fs, model, dims=11)
    if result["device_loop_calls"] or result["prior_device_populates"]:
        raise RuntimeError(f"gw_calibration took a device populate: {result}")
    return result


#: short runs of the standard sampler's options on ``IntegrationTestModel(2)``
#: at nlive 500 (seed 1234): name, options and the kernels the run must
#: launch; each also has its own check in ``phase_standard_options``
#: (options that do not interact share a run, for the time limit). The
#: first is the rounds populate, against which the likelihood split is
#: held: the device populate loop of the default path evaluates its pool
#: alone whatever ``fuse_likelihood`` says
STANDARD_OPTIONS_BASE = dict(nlive=500, seed=1234, resume=False, plot=False, checkpointing=False)
K1_RUN = ("k1_launches", "k1_backward_launches")
STANDARD_OPTION_RUNS = (
    ("rounds", dict(populate_mode="rounds"), K1_RUN),
    ("adaptive_radius", dict(constant_volume_mode=False), K1_RUN),
    ("fixed_radius", dict(fixed_radius=2.5), K1_RUN),
    ("truncation_rules", dict(truncation=["latent_radius", "min_log_q", "likelihood_threshold"]), K1_RUN),
    ("fuse_likelihood_false", dict(populate_mode="rounds", fuse_likelihood=False), K1_RUN),
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
        fused = results["rounds"]
        facts = dict(
            likelihood_evaluations=result["likelihood_evaluations"],
            fused_likelihood_evaluations=fused["likelihood_evaluations"],
            fused_iterations=fused["iterations"],
            same_logZ_bits_as_the_fused_run=result["logZ"] == fused["logZ"],
        )
        ok = (result["likelihood_evaluations"] < fused["likelihood_evaluations"]
              and facts["same_logZ_bits_as_the_fused_run"] and result["iterations"] == fused["iterations"])
    elif name == "max_iteration":
        facts = dict(iteration=int(ns.iteration))
        ok = ns.iteration == 2000
    elif name == "training_frequency":
        gaps = np.diff(ns.training_iterations).tolist()
        facts = dict(training_iterations=list(ns.training_iterations))
        ok = all(g >= 100 for g in gaps)
    elif name == "reset_acceptance_shrinkage_t":
        facts = dict(reset_acceptance=ns.reset_acceptance, expectation=ns.state.expectation,
                     logZ_logt=results["rounds"]["logZ"])
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


# ---------------------------------------------------------------------------
# The last members of the public classes, on the card
# ---------------------------------------------------------------------------
#: the members phase's flows: the flagship's RealNVP at [900, 2] and at
#: D = 5 (the width of ``examples/rosenbrock.py`` and of gw_basic's flow),
#: the NSF flagship's spline at [900, 2]
MEMBERS_ROWS = 900
MEMBERS_DIMS = (2, 5)
#: the draws' log-density on the card against the CPU flow's forward
#: log_prob of the same draws (a round trip through every coupling in
#: float32)
MEMBERS_DRAW_ATOL = 1e-4
#: the LARS base of the freeze_transform step
MEMBERS_LARS = dict(distribution="lars", distribution_kwargs=dict(n_neurons=16))


def _member_models(config, dims, seed=3):
    """A ``FlowModel`` of ``config``'s flow on the card and one on the CPU
    with the same weights, every weight perturbed by 0.05 N(0, 1)."""
    from nessai_tpu_torch.flowmodel import FlowModel

    models = []
    for device in ("cuda", "cpu"):
        fm = FlowModel(dict(config["flow_config"], n_inputs=dims), config.get("training_config"),
                       rng=np.random.default_rng(seed), device=device)
        fm.initialise()
        models.append(fm)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in models[0].flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
    models[1].flow.load_state_dict({k: v.cpu() for k, v in models[0].flow.state_dict().items()})
    for fm in models:
        fm.reset_optimiser()
    return models


def _members_sample_and_log_prob(name, config, dims):
    """``FlowModel.sample_and_log_prob`` in both forms on the card against
    the CPU: given latent points (with and without ``alt_dist``), the
    points and their log-density within the flow tolerance; drawn, the
    draws' log-density against the CPU flow's log_prob of the same
    draws."""
    gpu, cpu = _member_models(config, dims)
    z = np.random.default_rng(dims).standard_normal((MEMBERS_ROWS * 4, dims))
    z = z[np.linalg.norm(z, axis=1) <= 3.0][:MEMBERS_ROWS]
    errs = {}
    for form, kwargs in (("given_z", {}), ("alt_dist", dict(alt_dist=_AltDist()))):
        x_g, lp_g = gpu.sample_and_log_prob(z=z, **kwargs)
        x_c, lp_c = cpu.sample_and_log_prob(z=z, **kwargs)
        for a, b in ((x_g, x_c), (lp_g, lp_c)):
            torch.testing.assert_close(torch.as_tensor(a), torch.as_tensor(b), atol=FLOW_ATOL, rtol=FLOW_RTOL)
        errs[form] = max(float(np.abs(x_g - x_c).max()), float(np.abs(lp_g - lp_c).max()))
    x, lp = gpu.sample_and_log_prob(MEMBERS_ROWS)
    lp_cpu = cpu.log_prob(x)
    errs["draws"] = float(np.abs(lp - lp_cpu).max())
    if not np.isfinite(lp).all() or errs["draws"] > MEMBERS_DRAW_ATOL:
        raise RuntimeError(f"{name}: the draws' log-density is {errs['draws']} from the CPU flow's")
    return errs


class _AltDist:
    """A latent density for ``sample_and_log_prob(z=..., alt_dist=...)``:
    the unit Gaussian at a temperature of 2."""

    def log_prob(self, z):
        return -0.25 * np.sum(z**2, axis=1) - 0.5 * z.shape[1] * np.log(4 * np.pi)


def _members_loss(name, config):
    """``Flow.loss`` with its backward on the card against the CPU: the
    loss (weighted too) within the flow tolerance and every weight's
    gradient within the gradient tolerance of its largest."""
    gpu, cpu = _member_models(config, 2)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(1.5 * rng.standard_normal((MEMBERS_ROWS, 2)), dtype=torch.float32)
    w = torch.as_tensor(rng.uniform(0.1, 2.0, MEMBERS_ROWS), dtype=torch.float32)
    out = {}
    for weighted in (False, True):
        grads, losses = [], []
        for fm, device in ((gpu, "cuda"), (cpu, "cpu")):
            fm.flow.zero_grad(set_to_none=True)
            loss = fm.flow.loss(x.to(device), w.to(device) if weighted else None)
            loss.backward()
            losses.append(loss.item())
            grads.append({n: p.grad.detach().cpu() for n, p in fm.flow.named_parameters()})
        if abs(losses[0] - losses[1]) > FLOW_ATOL + FLOW_RTOL * abs(losses[1]):
            raise RuntimeError(f"{name}: loss {losses[0]} on the card, {losses[1]} on the CPU")
        share = 0.0
        for n, ref in grads[1].items():
            limit = GRAD_ATOL + GRAD_RTOL * ref.abs().max().item()
            diff = (grads[0][n] - ref).abs().max().item()
            share = max(share, diff / limit)
            if diff > limit:
                raise RuntimeError(f"{name}: the gradient in {n} differs by {diff} (limit {limit})")
        out["weighted" if weighted else "unweighted"] = dict(loss=losses[0], loss_cpu=losses[1],
                                                            max_share_of_gradient_tolerance=share)
    return out


def _members_freeze():
    """``freeze_transform``: one training step of a LARS-based RealNVP on
    the card and on the CPU from the same weights. The transform's
    weights stay bit-equal on both, the base's move, and the base's new
    weights agree within the gradient tolerance."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP

    config = dict(FLAGSHIP, flow_config=dict(FLAGSHIP["flow_config"], **MEMBERS_LARS))
    gpu, cpu = _member_models(config, 2)
    x = np.random.default_rng(9).standard_normal((MEMBERS_ROWS, 2)).astype(np.float32)
    after = []
    for fm in (gpu, cpu):
        fm.freeze_transform()
        before = {n: p.detach().clone() for n, p in fm.flow.named_parameters()}
        fm._train_step(torch.as_tensor(x, device=fm.device))
        now = {n: p.detach().clone() for n, p in fm.flow.named_parameters()}
        moved = [n for n in now if not torch.equal(now[n], before[n])]
        if not moved or any(not n.startswith("base.") for n in moved):
            raise RuntimeError(f"freeze_transform on {fm.device}: moved {moved}")
        fm.unfreeze_transform()
        after.append(now)
    err = max((after[0][n].cpu() - after[1][n]).abs().max().item() for n in after[1])
    if err > GRAD_ATOL:
        raise RuntimeError(f"freeze_transform: the base's step differs by {err} between the card and the CPU")
    return dict(base_weights_moved=sum(1 for n in after[1] if n.startswith("base.")), max_abs_err=err)


def phase_members():
    """The members that reach the kernels, on the card against the CPU:
    ``FlowModel.sample_and_log_prob`` (K1's inverse) at [900, 2] and at
    D = 5 and through the spline (K2's inverse); ``Flow.loss`` with its
    backward (K1 and K2 forward and backward); and one step of a
    LARS-based flow under ``freeze_transform``. Fails unless every output
    is within its tolerance and each of K1, K2 and their backward kernels
    launched."""
    from nessai_tpu_torch.utils.profiling import FLAGSHIP, FLAGSHIP_NSF

    counters = _k1_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    result = dict(
        sample_and_log_prob={
            **{f"realnvp_d{d}": _members_sample_and_log_prob(f"realnvp_d{d}", FLAGSHIP, d) for d in MEMBERS_DIMS},
            "nsf_d2": _members_sample_and_log_prob("nsf_d2", FLAGSHIP_NSF, 2),
        },
        loss={"realnvp": _members_loss("realnvp", FLAGSHIP), "nsf": _members_loss("nsf", FLAGSHIP_NSF)},
        freeze_transform=_members_freeze(),
    )
    torch.cuda.synchronize()
    launches = {key: int(getattr(w, a)) for key, (w, a) in counters.items()}
    result.update(rows=MEMBERS_ROWS, atol=FLOW_ATOL, rtol=FLOW_RTOL, draw_atol=MEMBERS_DRAW_ATOL, **launches)
    emit("members", **result)
    kernels = ("k1_launches", "k1_backward_launches", "rqs_launches", "rqs_backward_launches")
    if any(launches[k] == 0 for k in kernels):
        raise RuntimeError(f"members launched {({k: launches[k] for k in kernels})}")
    return result


# ---------------------------------------------------------------------------
# The example modules (nessai_tpu_torch/examples/), each at its own width
# ---------------------------------------------------------------------------
#: the iteration cap of an example whose run in full takes over 30 s on the
#: card (INS: a number of levels); None runs it to its end, with its pull.
#: In full on an H100 (PERF.md, Findings): the 5-D Rosenbrock 110.8 s and
#: 43,770 iterations, the INS Rosenbrock 94.8 s and 9 levels, the INS
#: Gaussian 84.1 s and 13 levels; each of the others 9-24 s a run. The
#: hypercube-prior example's INS run (94.2 s, 14 levels) stays in full: its
#: gate holds the two samplers' evidences within 3 sigma of each other.
EXAMPLE_CAPS = {
    "example_gaussian_2d": None,
    "example_unbounded_prior": None,
    "example_discrete_parameter": None,
    "example_rosenbrock": 12_000,
    "example_parallelisation": None,
    "example_corner_plot": None,
    "example_basic_ins": 3,
    "example_ins_gaussian": 4,
    "example_hypercube_prior": None,
    "example_ins_resume": None,
}
#: the level of ``ins_resume`` whose checkpoint the resumed run starts from
#: (its script checkpoints every two levels)
INS_RESUME_LEVEL = 4


def _example(name):
    import importlib

    return importlib.import_module(f"nessai_tpu_torch.examples.{name}")


def _example_config(kwargs, max_iteration):
    config = dict(kwargs, resume=False, plot=False, checkpointing=False)
    if max_iteration is not None:
        config["max_iteration"] = max_iteration
    return config


def _example_standard(name, model, kwargs, max_iteration=None, run_kwargs=None):
    """A standard-sampler example on the card, capped at ``max_iteration``
    or in full against its analytic log-evidence, with the gates of
    :func:`_check_standard`."""
    fs, model, nested, wall, launches = _drive(_example_config(kwargs, max_iteration), _k1_counters(),
                                               model=model, run_kwargs=run_kwargs)
    analytic = None if max_iteration is not None else float(model.analytic_log_evidence)
    result = _standard_result(fs, model, wall, launches, analytic)
    result["max_iteration"] = max_iteration
    emit(name, **result)
    _check_standard(name, result, nested, fs, model)
    return result, fs


def _example_ins(name, model, kwargs, max_iteration=None, run_kwargs=None):
    """An importance-nested-sampler example on the card, capped at
    ``max_iteration`` levels or in full against its analytic
    log-evidence. Fails unless K1 launched forward and backward, its
    posterior samples lie in the prior bounds and, in full, |pull| < 3."""
    from nessai_tpu_torch.utils.profiling import phase_times

    fs, model, samples, wall, launches = _drive(_example_config(kwargs, max_iteration), _k1_counters(),
                                                model=model, run_kwargs=run_kwargs)
    ns = fs.ns
    err = float(fs.logZ_error)
    analytic = None if max_iteration is not None else float(model.analytic_log_evidence)
    result = dict(
        logZ=fs.logZ,
        logZ_err=err,
        analytic=analytic,
        pull=None if analytic is None else (fs.logZ - analytic) / err,
        max_iteration=max_iteration,
        iterations=int(ns.iteration),
        samples=int(len(samples)),
        final_ess=float(ns.state.effective_n_posterior_samples),
        likelihood_evaluations=int(model.likelihood_evaluations),
        wall_s=wall,
        **phase_times(fs),
        **launches,
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    emit(name, **result)
    if launches["k1_launches"] == 0 or launches["k1_backward_launches"] == 0:
        raise RuntimeError(f"{name} launched K1 {launches['k1_launches']} / {launches['k1_backward_launches']}")
    if result["pull"] is not None and (not math.isfinite(result["pull"]) or abs(result["pull"]) >= PULL_LIMIT):
        raise RuntimeError(f"{name} logZ pull {result['pull']} is not within {PULL_LIMIT} sigma")
    if not _in_bounds(fs.posterior_samples, model):
        raise RuntimeError(f"{name}: posterior samples are empty, not finite or outside the prior bounds")
    return result, fs


def _figure(name, write):
    """``write()`` a figure and read it back: its path, bytes and pixels.
    The card's machine may have no matplotlib: then nothing is written,
    and the CPU tests hold the figure (tests/test_torch_examples.py)."""
    if not _has_plotting():
        return dict(figure=None, figure_not_written="matplotlib is not installed")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image

    path = write()
    image = matplotlib.image.imread(path)
    if image.ndim != 3 or min(image.shape[:2]) < 100:
        raise RuntimeError(f"{name}: the figure read back has the shape {image.shape}")
    return dict(figure=os.path.basename(path), figure_bytes=os.path.getsize(path), figure_pixels=list(image.shape[:2]))


def phase_example_gaussian_2d():
    """``examples/2d_gaussian.py`` (nlive 2000, seed 1234, a device
    likelihood) against -log 400."""
    m = _example("gaussian_2d")
    result, _ = _example_standard("example_gaussian_2d", m.GaussianModel(), m.SAMPLER_KWARGS,
                                  EXAMPLE_CAPS["example_gaussian_2d"])
    return {"example_gaussian_2d": result}


def phase_example_unbounded_prior():
    """``examples/unbounded_prior.py``: a normal prior on y drawn by the
    model, the z-score reparameterisation on it, against its analytic
    log-evidence."""
    m = _example("unbounded_prior")
    result, _ = _example_standard("example_unbounded_prior", m.GaussianPriorModel(), m.SAMPLER_KWARGS,
                                  EXAMPLE_CAPS["example_unbounded_prior"])
    return {"example_unbounded_prior": result}


def phase_example_discrete_parameter():
    """``examples/discrete_parameter.py``: ``dequantise`` on w, a host loop
    likelihood, against the quadrature of its evidence; the posterior's w
    must be integers."""
    m = _example("discrete_parameter")
    name = "example_discrete_parameter"
    result, fs = _example_standard(name, m.DiscreteModel(), m.SAMPLER_KWARGS, EXAMPLE_CAPS[name])
    w = fs.posterior_samples["w"]
    if not np.array_equal(w, np.round(w)):
        raise RuntimeError(f"{name}: the posterior's w is not integer")
    result["posterior_w_ones"] = int((w == 1).sum())
    return {name: result}


def phase_example_rosenbrock():
    """``examples/rosenbrock.py``: the 5-D Rosenbrock likelihood with a 4 ×
    [10 × 3] RealNVP (K1 at D = 5), against the transfer-matrix
    quadrature of its evidence."""
    m = _example("rosenbrock")
    name = "example_rosenbrock"
    result, _ = _example_standard(name, m.RosenbrockModel(m.DIMS), m.SAMPLER_KWARGS, EXAMPLE_CAPS[name])
    return {name: result}


def phase_example_parallelisation():
    """``examples/parallelisation_example.py``: a scalar host likelihood on
    a pool of two worker processes. Fails unless the run has the same
    bits, iterations and likelihood count as the same run without the
    pool, and the pool is closed at its end (as ``pool_reparam_angle``)."""
    import multiprocessing

    m = _example("parallelisation_example")
    name = "example_parallelisation"
    plain_kwargs = {k: v for k, v in m.SAMPLER_KWARGS.items() if k != "n_pool"}
    plain, _ = _example_standard(f"{name}_without_pool", m.ScalarGaussian(), plain_kwargs, EXAMPLE_CAPS[name])
    model = m.ScalarGaussian()
    pooled, _ = _example_standard(name, model, m.SAMPLER_KWARGS, EXAMPLE_CAPS[name])
    children = multiprocessing.active_children()
    checks = {
        "logZ bits": pooled["logZ"] == plain["logZ"],
        "iterations": pooled["iterations"] == plain["iterations"],
        "likelihood evaluations": pooled["likelihood_evaluations"] == plain["likelihood_evaluations"],
        "pool closed": model.pool is None and not children,
    }
    emit(f"{name}_checks", checks=checks, live_children=len(children))
    if not all(checks.values()):
        raise RuntimeError(f"{name}: failed {[k for k, v in checks.items() if not v]}")
    return {f"{name}_without_pool": plain, name: pooled}


def phase_example_corner_plot():
    """``examples/corner_plot_example.py``: the run against -log 400, then
    its corner plot (the seaborn pair grid without ``corner``) written and
    read back."""
    m = _example("corner_plot_example")
    name = "example_corner_plot"
    run_kwargs = {k: v for k, v in m.RUN_KWARGS.items() if k != "plot"}
    root = os.path.dirname(os.path.abspath(__file__))
    result, fs = _example_standard(name, m.GaussianModel(), m.SAMPLER_KWARGS, EXAMPLE_CAPS[name], run_kwargs)
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as output:
        result.update(_figure(name, lambda: m.plot_posterior(fs, output)))
    emit(f"{name}_figure", **{k: v for k, v in result.items() if k.startswith("figure")})
    return {name: result}


def phase_example_basic_ins():
    """``examples/importance_nested_sampler/basic_ins_example.py``: the 2-D
    Rosenbrock likelihood, nlive 2000, ``draw_constant``, against the
    quadrature of its evidence."""
    m = _example("importance_nested_sampler.basic_ins_example")
    name = "example_basic_ins"
    result, _ = _example_ins(name, m.RosenbrockModel(m.DIMS), m.SAMPLER_KWARGS, EXAMPLE_CAPS[name])
    return {name: result}


def phase_example_ins_gaussian():
    """``examples/importance_nested_sampler/ins_gaussian.py``: the 4-D
    Gaussian, nlive 2000, against -4 log 20."""
    m = _example("importance_nested_sampler.ins_gaussian")
    name = "example_ins_gaussian"
    result, _ = _example_ins(name, m.GaussianModel(m.DIMS), m.SAMPLER_KWARGS, EXAMPLE_CAPS[name])
    return {name: result}


def phase_example_hypercube_prior():
    """``examples/importance_nested_sampler/hypercube_prior.py``: both
    samplers at nlive 1000 on the prior that is not uniform in the
    hypercube, each against the analytic evidence and the two within 3
    sigma of each other, then both posteriors in one figure, written and
    read back."""
    m = _example("importance_nested_sampler.hypercube_prior")
    name = "example_hypercube_prior"
    cap = EXAMPLE_CAPS[name]
    standard, fs = _example_standard(f"{name}_standard", m.ModelWithNonUniformPrior(m.DIMS), m.STANDARD_KWARGS, cap)
    ins, fs_ins = _example_ins(name, m.ModelWithNonUniformPrior(m.DIMS), m.SAMPLER_KWARGS, cap)
    gap = (standard["logZ"] - ins["logZ"]) / math.hypot(standard["logZ_err"], ins["logZ_err"])
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as output:
        figure = _figure(name, lambda: m.plot_comparison(fs, fs_ins, output))
    emit(f"{name}_comparison", standard_logZ=standard["logZ"], ins_logZ=ins["logZ"], pull_between=gap, **figure)
    if cap is None and (not math.isfinite(gap) or abs(gap) >= PULL_LIMIT):
        raise RuntimeError(f"{name}: the two samplers are {gap} sigma apart")
    ins.update(pull_between_samplers=gap, **figure)
    return {f"{name}_standard": standard, name: ins}


def phase_example_ins_resume():
    """``examples/importance_nested_sampler/ins_resume.py`` (checkpointed
    every two levels), interrupted at the checkpoint of level
    ``INS_RESUME_LEVEL`` (a level cap), then resumed from the file in this
    process on the card: the samples bit for bit as checkpointed, log_q
    recomputed through the reloaded levels within 1e-5, logZ within 1e-8,
    K1 launched after the resume, and the resumed run to its end within 3
    sigma of -log 400 (as ``resume_ins``)."""
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.samplers.base import safe_file_dump

    m = _example("importance_nested_sampler.ins_resume")
    name = "example_ins_resume"
    recorded = {}

    def at_checkpoint(sampler):
        # the forced checkpoint of the finished (capped) run is not kept
        if sampler.finalised:
            return
        safe_file_dump(sampler, sampler.resume_file)
        recorded.update(
            iteration=int(sampler.iteration),
            samples=sampler.training_samples.samples.copy(),
            log_q=sampler.training_samples.log_q.copy(),
            logZ=float(sampler.log_evidence),
        )

    counters = _k1_counters()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as output:
        config = dict(m.SAMPLER_KWARGS, plot=False)
        start = time.perf_counter()
        first = FlowSampler(m.GaussianModel(), output=output, device="cuda",
                            **dict(config, max_iteration=INS_RESUME_LEVEL, checkpoint_callback=at_checkpoint))
        first.run(plot=False, save=False)
        first_wall = time.perf_counter() - start
        model = m.GaussianModel()
        fs = FlowSampler(model, output=output, device="cuda", **config)
        ns = fs.ns
        at_resume = dict(
            iteration=int(ns.iteration),
            samples_bitwise=ns.training_samples.samples.tobytes() == recorded["samples"].tobytes(),
            log_q_max_abs_err=float(np.abs(ns.training_samples.log_q - recorded["log_q"]).max()),
            logZ_abs_err=abs(float(ns.log_evidence) - recorded["logZ"]),
        )
        ns.configure_iterations(max_iteration=EXAMPLE_CAPS[name])
        for wrapper, attr in counters.values():
            setattr(wrapper, attr, 0)
        start = time.perf_counter()
        fs.run(plot=False, save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {key: int(getattr(w, a)) for key, (w, a) in counters.items()}
    analytic = float(model.analytic_log_evidence)
    err = float(fs.logZ_error)
    result = dict(
        checkpoint_level=recorded.get("iteration"),
        at_resume=at_resume,
        first_wall_s=first_wall,
        logZ=fs.logZ,
        logZ_err=err,
        analytic=analytic,
        pull=(fs.logZ - analytic) / err,
        iterations=int(ns.iteration),
        wall_s=wall,
        log_q_tol=RESUME_LOG_Q_TOL,
        logZ_tol=RESUME_LOGZ_TOL,
        **launches,
    )
    emit(name, **result)
    checks = {
        f"checkpoint at level {INS_RESUME_LEVEL}": result["checkpoint_level"] == INS_RESUME_LEVEL,
        "resumed at the checkpoint": at_resume["iteration"] == INS_RESUME_LEVEL,
        "samples bit for bit": at_resume["samples_bitwise"],
        "log_q within 1e-5": at_resume["log_q_max_abs_err"] <= RESUME_LOG_Q_TOL,
        "logZ within 1e-8": at_resume["logZ_abs_err"] <= RESUME_LOGZ_TOL,
        "K1 launched after resume": launches["k1_launches"] > 0 and launches["k1_backward_launches"] > 0,
        "levels added after resume": result["iterations"] > INS_RESUME_LEVEL,
        "|pull| < 3": math.isfinite(result["pull"]) and abs(result["pull"]) < PULL_LIMIT,
    }
    if not all(checks.values()):
        raise RuntimeError(f"{name}: failed {[k for k, v in checks.items() if not v]}")
    return {name: result}


#: the example phases, each a dict of its runs by name
EXAMPLE_PHASES = {
    "example_gaussian_2d": phase_example_gaussian_2d,
    "example_unbounded_prior": phase_example_unbounded_prior,
    "example_discrete_parameter": phase_example_discrete_parameter,
    "example_rosenbrock": phase_example_rosenbrock,
    "example_parallelisation": phase_example_parallelisation,
    "example_corner_plot": phase_example_corner_plot,
    "example_basic_ins": phase_example_basic_ins,
    "example_ins_gaussian": phase_example_ins_gaussian,
    "example_hypercube_prior": phase_example_hypercube_prior,
    "example_ins_resume": phase_example_ins_resume,
}


#: phases run in a process of their own, beside the main process's phases
#: from ``flagship_mesh`` on (for the script's time: a
#: sampler run keeps the GPU busy for a small share of its wall, PERF.md
#: §5, and no phase reads another's wall); each prints its line as before,
#: and their seconds are the ``seconds`` line's ``in_background``
BACKGROUND_PHASES = {
    "flagship_ins_mixture": phase_flagship_ins_mixture,
    "ins_options": phase_ins_options,
    "flagship_ins_hypercube": phase_flagship_ins_hypercube,
    "standard_options": phase_standard_options,
}
#: seconds the background process may take, from its start
BACKGROUND_TIMEOUT_S = 900


def _child_phases(phases):
    """``phases`` one after another, with their seconds, at a lower
    scheduling priority than the main process's phases (the host's cores
    go to those first)."""
    os.nice(10)
    _gpu_settings()
    seconds = {}
    results = {name: timed(seconds, name, phase) for name, phase in phases.items()}
    _child_result(seconds=seconds, results=results)


def child_background(output):
    _child_phases(BACKGROUND_PHASES)


def child_examples(output):
    _child_phases(EXAMPLE_PHASES)


class _Background:
    """``chip_smoke.py --child <child>`` (``background``: the
    ``BACKGROUND_PHASES``; ``examples``: the ``EXAMPLE_PHASES``), started
    at once: its phases run beside the phases that follow."""

    def __init__(self, child="background"):
        root = os.path.dirname(os.path.abspath(__file__))
        self.dir = tempfile.mkdtemp(dir=root, prefix=f".chip_smoke_{child}_")
        self.log = os.path.join(self.dir, f"{child}.log")
        self.child = child
        self.start = time.perf_counter()
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", child, self.dir],
                stdout=out,
                stderr=subprocess.STDOUT,
            )

    def collect(self):
        """Wait for the process, print its phase lines and return its
        seconds and results; raises if it failed."""
        rc = self.proc.wait(timeout=max(1.0, BACKGROUND_TIMEOUT_S - (time.perf_counter() - self.start)))
        with open(self.log) as f:
            lines = f.read().splitlines()
        result = None
        for line in lines:
            if line.startswith('{"phase"'):
                print(line, flush=True)
            elif line.startswith('{"child_result"'):
                result = json.loads(line)["child_result"]
        if rc != 0 or result is None:
            print("\n".join(lines[-60:]), file=sys.stderr, flush=True)
            raise RuntimeError(f"the {self.child} phases failed with exit code {rc}")
        return result

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


CHILDREN = {
    "standard_first": child_standard_first,
    "standard_resume": child_standard_resume,
    "ins_first": child_ins_first,
    "ins_resume": child_ins_resume,
    "background": child_background,
    "examples": child_examples,
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
    """The three resume phases in one fresh directory. The standard and the
    INS resume phases run at the same time, each in a thread of its own
    waiting on its child processes (the children's start, not their runs,
    takes most of each phase's wall; for the script's time),
    so their seconds are one entry, ``resume_standard_and_ins``; each
    phase's line gives its children's walls."""
    import concurrent.futures

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_resume_") as output:
        standard = os.path.join(output, "standard")
        ins = os.path.join(output, "ins")
        os.makedirs(standard)
        os.makedirs(ins)
        start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            futures = dict(
                resume_standard=pool.submit(phase_resume_standard, standard),
                resume_ins=pool.submit(phase_resume_ins, ins),
            )
            # both are waited for, and the first failure is raised
            results = {name: future.result() for name, future in futures.items()}
        seconds["resume_standard_and_ins"] = time.perf_counter() - start
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
    if sys.argv[1:2] == ["--gw-in-full"]:
        logging.getLogger("nessai_tpu_torch").setLevel(logging.INFO)
        logging.getLogger("nessai_tpu_torch").addHandler(logging.StreamHandler())
        seconds = {}
        try:
            timed(seconds, "environment", phase_environment)
            timed(seconds, "build", phase_build)
            timed(seconds, "gw_full", phase_gw_full, max_iteration=None)
            timed(seconds, "gw_toy_cbc", phase_gw_toy_cbc, max_iteration=None)
            timed(seconds, "gw_calibration", phase_gw_calibration, max_iteration=None)
            timed(seconds, "gw_ins", phase_gw_ins, max_iteration=None)
            emit("seconds", **seconds, total=sum(seconds.values()))
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    background = examples = None
    try:
        from nessai_tpu_torch.utils.profiling import FLAGSHIP, FLAGSHIP_NSF, GW_FULL_PROFILE_ITERATIONS

        seconds = {}
        smi = timed(seconds, "environment", phase_environment)
        timed(seconds, "build", phase_build)
        max_err = timed(seconds, "k1_vs_plain", phase_k1)
        max_err_layer, main_layer = timed(seconds, "k1_layer_vs_plain", phase_k1_layer)
        max_err_k2, main_k2 = timed(seconds, "k2_vs_plain", phase_k2)
        max_err_k2_inverse, main_k2_inverse = timed(seconds, "k2_inverse_backward_vs_plain",
                                                    phase_k2_inverse_backward)
        nsf_inverse = timed(seconds, "nsf_inverse_training", phase_nsf_inverse_training)
        members = timed(seconds, "members", phase_members)
        main_scan = timed(seconds, "ns_scan_vs_plain", phase_ns_scan)
        timed(seconds, "flow_realnvp", phase_flow, FLAGSHIP, "realnvp", scale=0.05)
        # the reference in float64: the plain spline in float32 strays
        # from the exact spline by more than the kernel, which computes
        # in double (PERF.md, Findings)
        timed(seconds, "flow_nsf", phase_flow, FLAGSHIP_NSF, "nsf",
              scale=NSF_FLOW_PERTURBATION, reference_dtype=torch.float64)
        phase_new_flows(seconds)
        # the conditional flows of the clustering proposal: a one-hot
        # context of 8 labels in every coupling's net
        timed(seconds, "flow_realnvp_context", phase_flow, FLAGSHIP, "realnvp_context", scale=0.05,
              context_features=CONTEXT_FEATURES)
        timed(seconds, "flow_nsf_context", phase_flow, FLAGSHIP_NSF, "nsf_context", scale=NSF_FLOW_PERTURBATION,
              reference_dtype=torch.float64, context_features=CONTEXT_FEATURES)
        timed(seconds, "ins_flow", phase_ins_flow)
        timed(seconds, "reparam_inverse", phase_reparam_inverse)
        timed(seconds, "gw_likelihood_gpu_vs_host", phase_gw_likelihood, smi)
        timed(seconds, "mesh_dp_step", phase_mesh_dp_step)
        flagship = timed(seconds, "flagship", phase_flagship)
        background = _Background()
        examples = _Background("examples")
        flagship_mesh = timed(seconds, "flagship_mesh", phase_flagship_mesh, flagship)
        bookkeeping = timed(seconds, "flagship_device_loop", phase_flagship_device_loop, flagship)
        flagship_nsf = timed(seconds, "flagship_nsf", phase_flagship_nsf)
        rounds = timed(seconds, "flagship_rounds", phase_flagship_rounds)
        split = timed(seconds, "flagship_fuse_likelihood_false", phase_flagship_fuse_likelihood_false, rounds)
        flagship_ins = timed(seconds, "flagship_ins", phase_flagship_ins)
        flagship_ins_mesh = timed(seconds, "flagship_ins_mesh", phase_flagship_ins_mesh, flagship_ins)
        inversion = timed(seconds, "flagship_reparam_inversion", phase_flagship_reparam_inversion)
        angle = timed(seconds, "flagship_reparam_angle", phase_flagship_reparam_angle)
        lu = timed(seconds, "flagship_lu", phase_flagship_lu)
        eggbox = timed(seconds, "flagship_eggbox", phase_flagship_eggbox)
        augmented = timed(seconds, "flagship_augmented", phase_flagship_augmented)
        mcmc = timed(seconds, "flagship_mcmc", phase_flagship_mcmc)
        clustering = timed(seconds, "flagship_clustering", phase_flagship_clustering)
        gw_basic = timed(seconds, "gw_basic", phase_gw_basic)
        gw_callback = timed(seconds, "gw_callback", phase_gw_callback, gw_basic)
        gw_ins = timed(seconds, "gw_ins", phase_gw_ins, gw_basic)
        gw_full = timed(seconds, "gw_full", phase_gw_full, GW_FULL_PROFILE_ITERATIONS)
        gw_toy_cbc = timed(seconds, "gw_toy_cbc", phase_gw_toy_cbc)
        gw_calibration = timed(seconds, "gw_calibration", phase_gw_calibration)
        checkpointing = timed(seconds, "flagship_checkpointing", phase_flagship_checkpointing, flagship)
        pool = timed(seconds, "pool_reparam_angle", phase_pool_reparam_angle, angle)
        in_background = timed(seconds, "background_wait", background.collect)
        mixture, options, hypercube, standard_options = (
            in_background["results"][name] for name in BACKGROUND_PHASES
        )
        in_examples = timed(seconds, "examples_wait", examples.collect)
        example_runs = {run: r for name in EXAMPLE_PHASES for run, r in in_examples["results"][name].items()}
        resumed = phase_resume(seconds)
        emit("seconds", **seconds, total=sum(seconds.values()), in_background=in_background["seconds"],
             in_examples=in_examples["seconds"])
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        for process in (background, examples):
            if process is not None:
                process.stop()
    kernels = []
    runs = {
        "flagship": flagship,
        "flagship_mesh": flagship_mesh,
        **{f"flagship_{name}": r for name, r in bookkeeping.items()},
        "flagship_nsf": flagship_nsf,
        "flagship_rounds": rounds,
        "flagship_fuse_likelihood_false": split,
        "flagship_ins": flagship_ins,
        "flagship_ins_mesh": flagship_ins_mesh,
        "flagship_ins_mixture": mixture,
        **options,
        "flagship_reparam_inversion": inversion,
        "flagship_reparam_angle": angle,
        "flagship_lu": lu,
        "flagship_ins_hypercube": hypercube,
        "flagship_eggbox": eggbox,
        "flagship_augmented": augmented,
        "flagship_mcmc": mcmc,
        "flagship_clustering": clustering,
        "gw_basic": gw_basic,
        "gw_callback": gw_callback,
        "gw_ins": gw_ins,
        "gw_full": gw_full,
        "gw_toy_cbc": gw_toy_cbc,
        "gw_calibration": gw_calibration,
        **standard_options,
        "flagship_checkpointing": checkpointing,
        "pool_reparam_angle": pool,
        # the resumed processes' runs
        "resume_standard": resumed["resume_standard"],
        "resume_ins": resumed["resume_ins"],
        "nsf_inverse_training": nsf_inverse,
        "members": members,
        **example_runs,
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
    kernels.append(
        {
            "name": "rqs_inverse_backward",
            "route": "cuda",
            "source": "nessai_tpu_torch/csrc/rqs.cu",
            # the JAX package's backward in the inverse direction: jax.vjp
            # of the jnp reference with inverse=True
            "replaces": "nessai_tpu/ops/rqs_pallas.py:228",
            "variant": "the inverse direction (rqs_inverse_backward_launch); no sampler trains through it",
            "launches": nsf_inverse["rqs_inverse_backward_launches"],
            "launches_run": "nsf_inverse_training",
            "launches_by_run": {run: r["rqs_inverse_backward_launches"] for run, r in runs.items()},
            "max_abs_err": max(max_err_k2_inverse.values()),
            "ms": main_k2_inverse["ms"],
            "plain_ms": main_k2_inverse["plain_ms"],
            "bound_ms": main_k2_inverse["bound_ms"],
            "bound_by": main_k2_inverse["bound_by"],
            "library_ms": None,
            "timer": main_k2_inverse["timer"],
            "plain_timer": main_k2_inverse["plain_timer"],
            "shape": list(K2_INVERSE_BACKWARD_SHAPES[0][:3]),
            "card": smi,
        }
    )
    kernels.append(
        {
            "name": "ns_scan",
            "route": "cuda",
            "source": "nessai_tpu_torch/csrc/ns_scan.cu",
            # not Pallas: the JAX package's lax.scan, chained onto its pools
            "replaces": "nessai_tpu/samplers/ns_device.py:42",
            "launches": flagship["ns_scan_launches"],
            "launches_by_run": {run: r["ns_scan_launches"] for run, r in runs.items()},
            "max_abs_err": main_scan["max_abs_err"],
            "ms": main_scan["ms"],
            "plain_ms": main_scan["plain_ms"],
            "bound_ms": main_scan["bound_ms"],
            "bound_by": main_scan["bound_by"],
            # no PyTorch call computes the consume/insert scan
            "library_ms": None,
            "timer": main_scan["timer"],
            "plain_timer": main_scan["plain_timer"],
            "host_twin_ms": main_scan["host_twin_ms"],
            "shape": list(NS_SCAN_MAIN_SHAPE),
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
