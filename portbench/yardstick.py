"""The benchmark's yardstick: the card's peaks, the least time of each of
the program's kernels on its shapes, and the operations of a flow and a
likelihood.

A kernel's least time is the larger of its bytes over the memory
bandwidth and its operations over the float32 rate, counting each input
byte read once and each output byte written once. The counts of the
coupling kernel (K1) and of the consume/insert scan are those the port's
kernel table states; they are frozen here so that the program cannot
change the yardstick it is measured with.
"""

import math

__all__ = [
    "HBM_BYTES_PER_S",
    "FP32_FLOPS_PER_S",
    "TF32_FLOPS_PER_S",
    "least_seconds",
    "k1_cost",
    "scan_cost",
    "resnet_flops_per_row",
    "coupling_flops_per_row",
]

#: NVIDIA H100 SXM (data sheet, dense): HBM3 bandwidth and the float32
#: rate outside the tensor cores; TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12


def least_seconds(n_bytes, n_ops):
    """The larger of the bytes' time at the bandwidth and the operations'
    at the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S)


def k1_cost(n, D, n_tr, backward=False, inverse=False):
    """``(bytes, operations)`` of one launch of the coupling kernel on
    ``n`` rows of ``D`` columns, ``n_tr`` of them transformed.

    Forward (or inverse): x, raw_s and t read, y and the row
    log-determinant written, ``4 n (2 D + 2 n_tr + 1)`` bytes; 7
    operations a transformed element. Backward: g_y, g_ld, x's
    transformed columns, raw_s and, for the inverse, t read; g_x, g_raw
    and g_t written, ``4 n (2 D + 1 + n_tr (4 or 5))`` bytes; 11
    operations a transformed element, 17 for the inverse."""
    if backward:
        return 4 * n * (2 * D + 1 + n_tr * (5 if inverse else 4)), (17 if inverse else 11) * n * n_tr
    return 4 * n * (2 * D + 2 * n_tr + 1), 7 * n * n_tr


def scan_cost(n, k, accepted_shift_places):
    """``(bytes, operations)`` of one scan of a pool of ``k`` candidates
    against ``n`` live points: live and pool read, the mask, consumed ids,
    insertion indices, final ids and the count written; each candidate's
    binary search (``ceil(log2(n + 1)) + 2`` comparisons) and two moves a
    place of each accept's shift (``accepted_shift_places`` = the sum of
    the accepted insertion indices)."""
    n_bytes = 4 * n + 4 * k + k + 4 * k + 4 * k + 4 * n + 4
    n_ops = k * (math.ceil(math.log2(n + 1)) + 2) + 2 * int(accepted_shift_places)
    return n_bytes, n_ops


def resnet_flops_per_row(n_in, n_out, width, n_blocks):
    """Multiply-adds counted as two operations: the input layer, two dense
    layers a residual block and the output layer."""
    return 2 * (n_in * width + n_blocks * 2 * width * width + width * n_out)


def coupling_flops_per_row(n_id, n_tr, width, n_blocks, backward=False):
    """One affine coupling's conditioner and transform on one row; the
    backward pass counts twice the forward's matrix products (the
    gradients of the inputs and of the weights)."""
    forward = resnet_flops_per_row(n_id, 2 * n_tr, width, n_blocks) + 7 * n_tr
    return 3 * forward if backward else forward
