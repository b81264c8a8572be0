#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nessai_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each printing one JSON line: the environment; the nvcc build of
the affine-coupling kernel from ``nessai_tpu_torch/csrc``; that kernel
against its plain PyTorch version (both directions, gradients, times);
the flagship RealNVP on the GPU against the same weights on the CPU; the
flagship nested-sampling run (``bench.py``'s configuration) through
``FlowSampler(..., device="cuda")``; a ``kernels`` summary. The last line
is ``{"ok": true, "device": {...}}``. Any failing phase ends the script
with a non-zero exit code and without that line. Without a GPU the
script exits with code 2 at once.

Imports nothing of JAX or of the JAX package.
"""

import functools
import json
import math
import os
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
#: shape of the kernels-line numbers: a flagship training step
K1_MAIN_SHAPE = (900, 1)
Y_ATOL, Y_RTOL, LD_ATOL = 1e-6, 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
FLOW_ATOL, FLOW_RTOL = 1e-5, 1e-5
PULL_LIMIT = 3.0


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
    lib = _build.build("affine_coupling")
    seconds = time.perf_counter() - t0
    emit(
        "build",
        seconds=seconds,
        flags=" ".join(_build.NVCC_FLAGS),
        library=os.path.basename(str(lib)),
    )


def phase_k1():
    from nessai_tpu_torch.ops import coupling
    from nessai_tpu_torch.utils.profiling import device_time_ms

    gen = torch.Generator(device="cuda").manual_seed(20261016)
    rows = []
    max_err = 0.0
    main = None
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
            ms, _ = device_time_ms(kernel)
            plain_ms, plain_kernels = device_time_ms(plain)
            bound, bound_by = k1_bound_ms(n, d)
            row[tag] = {
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "plain_kernels_per_call": plain_kernels,
                "call_ms": time_ms(kernel),
                "plain_call_ms": time_ms(plain),
                "bound_ms": bound,
                "bound_by": bound_by,
            }
            if (n, d) == K1_MAIN_SHAPE and not inverse:
                main = row[tag]
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
            "200 calls; call_ms, plain_call_ms: CUDA-event time per call, "
            "median of 30 samples of 50 back-to-back calls"
        ),
        shapes=rows,
    )
    return max_err, main


def _flagship_flow(device, seed=0):
    from nessai_tpu_torch.flows import configure_model

    flow = configure_model(
        dict(n_inputs=2, n_blocks=4, n_neurons="auto", n_layers=2, seed=seed)
    )
    return flow.to(device)


def phase_flow(seed=7):
    flow_gpu = _flagship_flow("cuda")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        # move every weight away from the zero-initialised last layers
        for p in flow_gpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
    flow_cpu = _flagship_flow("cpu")
    flow_cpu.load_state_dict({k: v.cpu() for k, v in flow_gpu.state_dict().items()})
    # inputs in the range the flagship feeds the flow: z-scored live
    # points and latents truncated at a radius of a few sigma. (The
    # float32 error of log q grows with |z| · error(z): at |z| ~ 8 it
    # reaches 1e-5 on either device.)
    x = np.random.default_rng(seed + 4).normal(0, 1, (6000, 2))
    x = torch.as_tensor(x[np.linalg.norm(x, axis=1) <= 3.0][:4096], dtype=torch.float32)
    errs = {}
    shares = {}
    scale = {}
    with torch.no_grad():
        for name, f in (
            ("forward", lambda fl, a: fl(a)),
            ("inverse", lambda fl, a: fl.inverse(a)),
            ("log_prob", lambda fl, a: (fl.log_prob(a),)),
        ):
            out_gpu = f(flow_gpu, x.cuda())
            out_cpu = f(flow_cpu, x)
            err = share = 0.0
            for a, b in zip(out_gpu, out_cpu):
                torch.testing.assert_close(a.cpu(), b, atol=FLOW_ATOL, rtol=FLOW_RTOL)
                diff = (a.cpu() - b).abs()
                err = max(err, diff.max().item())
                share = max(share, (diff / (FLOW_ATOL + FLOW_RTOL * b.abs())).max().item())
            errs[name] = err
            shares[name] = share
            scale[name] = max(b.abs().max().item() for b in out_cpu)
    emit(
        "flow_gpu_vs_cpu",
        n=4096,
        atol=FLOW_ATOL,
        rtol=FLOW_RTOL,
        max_abs_err=errs,
        max_share_of_tolerance=shares,
        max_abs_value=scale,
    )


def phase_flagship():
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.ops import coupling
    from nessai_tpu_torch.utils.profiling import FLAGSHIP
    from nessai_tpu_torch.utils.testing import IntegrationTestModel

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as output:
        model = IntegrationTestModel(2)
        torch.cuda.reset_peak_memory_stats()
        coupling.affine_coupling.launches = 0
        start = time.perf_counter()
        # bench.py:51-63: nlive 1000, seed 1234, RealNVP 4 x [permutation,
        # resnet affine coupling, actnorm], 100 epochs, patience 20
        fs = FlowSampler(model, output=output, device="cuda", **FLAGSHIP)
        logZ, nested = fs.run(plot=False, save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = coupling.affine_coupling.launches
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
        k1_launches=int(launches),
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        posterior_samples=int(fs.posterior_samples.size),
    )
    emit("flagship", **result)
    if launches == 0:
        raise RuntimeError("the flagship run launched the affine-coupling kernel 0 times")
    if not math.isfinite(pull) or abs(pull) >= PULL_LIMIT:
        raise RuntimeError(f"logZ pull {pull} is not within {PULL_LIMIT} sigma")
    if len(nested) != ns.iteration + ns.nlive:
        raise RuntimeError("nested samples do not match iterations + nlive")
    post = fs.posterior_samples
    if not post.size or not all(np.isfinite(post[n]).all() for n in model.names):
        raise RuntimeError("posterior samples are empty or not finite")
    return result


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        smi = phase_environment()
        phase_build()
        max_err, main_k1 = phase_k1()
        phase_flow()
        flagship = phase_flagship()
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [
        {
            "name": "affine_coupling",
            "route": "cuda",
            "source": "nessai_tpu_torch/csrc/affine_coupling.cu",
            "replaces": "nessai_tpu/ops/coupling_pallas.py:56",
            "launches": flagship["k1_launches"],
            "max_abs_err": max_err,
            "ms": main_k1["ms"],
            "plain_ms": main_k1["plain_ms"],
            "bound_ms": main_k1["bound_ms"],
            "bound_by": main_k1["bound_by"],
            "library_ms": None,
            "shape": list(K1_MAIN_SHAPE),
            "card": smi,
        }
    ]
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
