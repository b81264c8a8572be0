"""Nested-sampling stepping on the device. Counterpart of
``nessai_tpu/samplers/ns_device.py``.

The consume/insert scan replays a whole populated pool in one launch:
skip or accept each candidate against the worst live point, insert it
into the sorted live set, and record the insertion index and the
consumed point's id (``ops/ns_scan.py``: the kernel and its plain
version ``ns_scan_plain``). These are float32 comparisons, exact
wherever every logL is float32-representable, which the sampler checks.
The float64 evidence recursion is replayed on the host over the scan's
trajectory (``NestedSampler._consume_from_pool_device``).

The flow proposal's device populate loop and the prior populate chain
the scan onto their pools on the device; the sampler calls
:func:`run_ns_scan` on its own only where the run's stopping decision
lands inside a pool.
"""

import numpy as np
import torch

from ..ops.ns_scan import INT32_MAX, ns_scan
from ..utils.device import get_device
from ..utils.profiling import counts
from ..utils.sampling import _bucket_size

__all__ = ["chain_scan", "run_ns_scan", "scan_consume", "scan_outputs_to_host"]


def scan_outputs_to_host(mask, consumed, ins, final_ids, n_acc, k=None):
    """The scan's outputs on the host in one copy: ``(mask [k] bool,
    consumed [k], ins [k], final_ids [n], n_acc)`` as int64 numpy arrays
    and an int, the pool outputs cut to their first ``k`` entries (all by
    default)."""
    kb = int(mask.shape[0])
    k = kb if k is None else int(k)
    packed = torch.cat([n_acc.reshape(1), mask.to(torch.int32), consumed, ins, final_ids]).cpu().numpy()
    counts.host_reads += 1
    return (
        packed[1 : 1 + k].astype(bool),
        packed[1 + kb : 1 + kb + k].astype(np.int64),
        packed[1 + 2 * kb : 1 + 2 * kb + k].astype(np.int64),
        packed[1 + 3 * kb :].astype(np.int64),
        int(packed[0]),
    )


def scan_consume(live_logl, pool_logl, max_accepts):
    """The consume/insert scan on device tensors: ``live_logl`` ([n],
    float32, sorted ascending) against ``pool_logl`` ([K], float32, in pop
    order), accepting at most ``max_accepts``. Returns ``(mask[K],
    consumed_ids[K], insertion_idx[K], final_live_ids[n], n_accepted)`` on
    the device, the ids indexing ``concat(live, pool_in_pop_order)``: the
    scan kernel's outputs (``ops.ns_scan``; its plain version on the
    CPU)."""
    return ns_scan(live_logl, pool_logl, min(int(max_accepts), INT32_MAX))


def chain_scan(log_l, perm, live32, max_accepts: int) -> dict:
    """The scan chained onto a pool populated on the device: ``log_l``,
    the pool's float32 likelihoods on the device, taken in the pop order
    of ``perm`` (the pool pops from the end of ``perm``) against the
    sorted ``live32``. Returns the outputs of :func:`scan_outputs_to_host`
    by name with the live set and the accept cap they were computed for,
    as ``NestedSampler._consume_from_pool_device`` reads them."""
    device = log_l.device
    max_accepts = min(int(max_accepts), INT32_MAX)
    perm_rev = torch.as_tensor(np.ascontiguousarray(perm[::-1]), dtype=torch.int64, device=device)
    live = torch.as_tensor(np.asarray(live32, np.float32), device=device)
    mask, consumed, ins, final_ids, n_acc = scan_outputs_to_host(
        *ns_scan(live, log_l[perm_rev].contiguous(), max_accepts)
    )
    return dict(
        mask=mask,
        consumed=consumed,
        ins=ins,
        final_ids=final_ids,
        n_acc=n_acc,
        live32=np.asarray(live32, np.float32),
        max_acc=max_accepts,
    )


def run_ns_scan(live32, pool32, max_accepts: int, device=None):
    """Replay the consume/insert steps of a pool on ``device`` (CUDA by
    default).

    ``live32``: (n,) float32, the live points' logL sorted ascending;
    ``pool32``: (K,) float32, the pool's logL in pop order;
    ``max_accepts``: accept no more than this many. The pool is padded
    with -inf (never accepted) to ``_bucket_size(K, 64)`` entries, as the
    JAX package pads it, and the outputs cut back to K.

    Returns ``(accept_mask[K], consumed_ids[K], insertion_idx[K],
    final_live_ids[n], n_accepted)``, the ids indexing
    ``concat(live_points, pool_in_pop_order)``; ``insertion_idx`` is the
    recorded index (``searchsorted - 1``), meaningful where
    ``accept_mask`` is set."""
    device = get_device(device)
    k = int(pool32.shape[0])
    kb = _bucket_size(k, minimum=64)
    pool_p = np.full(kb, -np.inf, np.float32)
    pool_p[:k] = pool32
    live = torch.as_tensor(np.ascontiguousarray(live32, np.float32), device=device)
    pool = torch.as_tensor(pool_p, device=device)
    out = ns_scan(live, pool, min(int(max_accepts), INT32_MAX))
    return scan_outputs_to_host(*out, k=k)
