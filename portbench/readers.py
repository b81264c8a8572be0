"""Arithmetic that the metric readers share: shares of the window from the
harness's spans, milliseconds an epoch, a kernel's roofline share, the
step's share of the peak and the device's idle share. Each returns None
where it finds nothing to read."""

import torch

from .trace import union_seconds
from .yardstick import FP32_FLOPS_PER_S, TF32_FLOPS_PER_S, coupling_flops_per_row, k1_cost, least_seconds

__all__ = ["span_share", "host_share", "epoch_ms", "k1_roofline", "step_mfu", "idle_share"]

#: K1's kernels (forward or inverse, and backward) by name in the trace
K1_KERNELS = ("affine_coupling_kernel", "affine_coupling_backward_kernel")


def span_share(window, names):
    """Percent of the window covered by the spans named ``names``."""
    spans = [(s, e) for n, s, e, _ in window.rec.clipped_spans() if n in names]
    return 100.0 * union_seconds(spans) / window.seconds


def host_share(window, device_layers):
    """Percent of the window outside the spans named ``device_layers``."""
    return 100.0 - span_share(window, device_layers)


def epoch_ms(window):
    """Milliseconds an epoch of the trainings that ended inside the window."""
    done = [
        (s, e, epochs)
        for name, s, e, epochs in window.rec.spans
        if name == "training" and s >= window.t0 and e <= window.t_end
    ]
    epochs = sum(x[2] for x in done)
    if not epochs:
        return None
    return 1e3 * sum(e - s for s, e, _ in done) / epochs


def k1_roofline(window):
    """Percent: the least time of every K1 launch the traced window made
    over the device time of K1's kernels."""
    if window.trace is None:
        return None
    by_name = window.trace.seconds_by_name(window.t0, window.t_close)
    device = sum(t for name, t in by_name.items() if any(k in name for k in K1_KERNELS))
    if device <= 0:
        return None
    bound = 0.0
    for (n, D, n_tr, inverse, backward), count in window.rec.k1.items():
        bound += count * least_seconds(*k1_cost(n, D, n_tr, backward=False, inverse=inverse))
        if backward:
            bound += count * least_seconds(*k1_cost(n, D, n_tr, backward=True, inverse=inverse))
    return 100.0 * bound / device


def step_mfu(window):
    """Percent of the card's float32 peak (TF32 where matmuls take it):
    the operations of every coupling the traced window ran and of every
    likelihood evaluation, over the traced window's seconds."""
    if window.trace is None or window.flow_widths is None:
        return None
    width, n_blocks = window.flow_widths
    flops = 0.0
    for (n, D, n_tr, _inverse, backward), count in window.rec.k1.items():
        flops += count * n * coupling_flops_per_row(D - n_tr, n_tr, width, n_blocks, backward=backward)
    flops += window.traced_evaluations * float(window.config["likelihood_flops_per_row"])
    peak = TF32_FLOPS_PER_S if torch.backends.cuda.matmul.allow_tf32 else FP32_FLOPS_PER_S
    return 100.0 * flops / (window.traced_seconds * peak)


def idle_share(window):
    """Percent of the traced window in which nothing ran on the card."""
    if window.trace is None:
        return None
    return 100.0 * (1.0 - union_seconds(window.trace.clipped(window.t0, window.t_close)) / window.traced_seconds)
