"""The nested-sampling consume/insert scan: the CUDA kernel and its plain
PyTorch version.

Replaces ``scan_consume``, the ``lax.scan`` of
``nessai_tpu/samplers/ns_device.py`` (line 42) that the JAX package
chains onto its device-resident pool. Over a pool of candidate logL in
pop order and the sorted live logL, each step accepts the candidate
where it beats the worst live point (while fewer than ``max_accepts``
were accepted), records the consumed id and the insertion index, and
inserts the candidate into the sorted live set. The kernel is
``csrc/ns_scan.cu`` (``ns_scan_launch``), built with nvcc for ``sm_90a``
and bound with ctypes (see ``_build.py``): one launch of one block per
pool. What bounds it is the chain of accepted steps, not bytes or
operations. Rejections go 32 at a time by a warp vote, an accepted step
is a count and a shift over the live set spread over the block's
threads with one barrier, and the steps after the accept cap run in
parallel. The live set stays where :func:`memory_path` says: in
registers up to ``REGISTER_MAX_LIVE`` entries, in shared memory up to
``SHARED_MAX_LIVE`` (a ring a thread), with the ids in global scratch up
to ``SHARED_VALUES_MAX_LIVE`` and all of it in global scratch above. The
source says how its design treats each.

:func:`ns_scan` takes a CUDA tensor to the kernel (each launch adds one
to ``ns_scan.launches``) and a CPU tensor to :func:`ns_scan_plain`; any
other device raises. There is no fall-back from one to the other.
"""

import ctypes
import functools

import torch

__all__ = [
    "ns_scan",
    "ns_scan_plain",
    "memory_path",
    "INT32_MAX",
    "block_shape",
    "REGISTER_MAX_LIVE",
    "SHARED_MAX_LIVE",
    "SHARED_VALUES_MAX_LIVE",
]

INT32_MAX = 2**31 - 1


def ns_scan_plain(live, pool, max_accepts):
    """Plain PyTorch version, a literal statement of ``scan_consume``:
    ``live`` ``[n]`` float32 sorted ascending, ``pool`` ``[K]`` float32 in
    pop order. Per step ``ok = (p > live[0]) & (n_acc < max_accepts)``,
    ``idx = sum(live < p)``; on ``ok`` the entries below ``idx - 1``
    shift down one and the candidate goes to ``idx - 1``. Returns
    ``(mask [K] bool, consumed [K], ins [K], final_ids [n], n_acc)``
    (int32; ``consumed`` is -1 where not accepted, ``ins`` is ``idx - 1``
    on every step), with ids indexing ``concat(live, pool)``."""
    n = int(live.shape[0])
    k = int(pool.shape[0])
    device = live.device
    arange_n = torch.arange(n, dtype=torch.int32, device=device)
    ids = arange_n.clone()
    n_acc = torch.zeros((), dtype=torch.int32, device=device)
    max_accepts = torch.tensor(min(int(max_accepts), INT32_MAX), dtype=torch.int32, device=device)
    minus_one = torch.tensor(-1, dtype=torch.int32, device=device)
    mask = torch.empty(k, dtype=torch.bool, device=device)
    consumed = torch.empty(k, dtype=torch.int32, device=device)
    ins = torch.empty(k, dtype=torch.int32, device=device)
    for j in range(k):
        p = pool[j]
        ok = (p > live[0]) & (n_acc < max_accepts)
        idx = torch.sum(live < p).to(torch.int32)
        cons = ids[0]
        below = arange_n < idx - 1
        at = arange_n == idx - 1
        new_live = torch.where(below, torch.roll(live, -1), live)
        new_live = torch.where(at, p, new_live)
        new_ids = torch.where(below, torch.roll(ids, -1), ids)
        new_ids = torch.where(at, n + j, new_ids)
        live = torch.where(ok, new_live, live)
        ids = torch.where(ok, new_ids, ids)
        n_acc = n_acc + ok.to(torch.int32)
        mask[j] = ok
        consumed[j] = torch.where(ok, cons, minus_one)
        ins[j] = idx - 1
    return mask, consumed, ins, ids, n_acc


def _check(live, pool) -> None:
    for name, a in (("live", live), ("pool", pool)):
        if a.dtype != torch.float32:
            raise TypeError(f"ns_scan: {name} must be float32, got {a.dtype}")
        if a.dim() != 1:
            raise ValueError(f"ns_scan: {name} must be 1-D, got shape {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"ns_scan: {name} must be contiguous")
    if pool.device != live.device:
        raise ValueError(f"ns_scan: pool is on {pool.device}, live on {live.device}")
    if live.shape[0] < 1:
        raise ValueError("ns_scan: the live set is empty")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/ns_scan.cu``, built at first use."""
    from ._build import load

    fn = load("ns_scan").ns_scan_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # live, pool, n, k, max_accepts, mask, consumed, ins, final_ids, n_acc, work_live, work_ids, stream
    fn.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


#: live sets of up to this many entries step in registers: one warp of
#: 8, 16 or 32 entries a lane up to 1024, then 16 a thread in up to 8 warps
REGISTER_MAX_LIVE = 4096
#: larger ones step in one block of 32 * min(32, ceil(n / 1024)) threads,
#: each owning R = ceil(n / threads) live points (``block_shape``), their
#: logL and ids in shared memory up to this many entries, 8 bytes each in
#: 224 KB ...
SHARED_MAX_LIVE = 28 * 1024
#: ... and their logL alone up to this many, the ids in global scratch;
#: above it both are in global scratch
SHARED_VALUES_MAX_LIVE = 56 * 1024


def block_shape(n: int):
    """``(threads, R)``: the threads that step ``n`` live points, ``R``
    entries each, as ``csrc/ns_scan.cu`` chooses them."""
    if n <= REGISTER_MAX_LIVE:
        per_thread = 8 if n <= 256 else 16 if n <= 512 else 32 if n <= 1024 else 16
        return 32 * -(-n // (32 * per_thread)), per_thread
    threads = 32 * min(32, -(-n // 1024))
    return threads, -(-n // threads)


def memory_path(n: int) -> str:
    """Where the kernel holds a live set of ``n`` entries while it steps:
    ``"register"``, ``"shared"``, ``"global_ids"`` (the logL in shared
    memory, the ids in global scratch) or ``"global"``."""
    if n <= REGISTER_MAX_LIVE:
        return "register"
    if n <= SHARED_MAX_LIVE:
        return "shared"
    return "global_ids" if n <= SHARED_VALUES_MAX_LIVE else "global"


def _launch(live, pool, max_accepts):
    n, k = live.shape[0], pool.shape[0]
    device = live.device
    mask = torch.empty(k, dtype=torch.bool, device=device)
    consumed = torch.empty(k, dtype=torch.int32, device=device)
    ins = torch.empty(k, dtype=torch.int32, device=device)
    final_ids = torch.empty(n, dtype=torch.int32, device=device)
    n_acc = torch.empty((), dtype=torch.int32, device=device)
    work_live = work_ids = None
    path = memory_path(n)
    if path in ("global_ids", "global"):
        threads, per_thread = block_shape(n)
        work_ids = torch.empty(threads * per_thread, dtype=torch.int32, device=device)
        if path == "global":
            work_live = torch.empty(threads * per_thread, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _kernel()(
            live.data_ptr(), pool.data_ptr(), n, k, min(int(max_accepts), INT32_MAX),
            mask.data_ptr(), consumed.data_ptr(), ins.data_ptr(), final_ids.data_ptr(), n_acc.data_ptr(),
            0 if work_live is None else work_live.data_ptr(),
            0 if work_ids is None else work_ids.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ns_scan kernel launch failed with cudaError {err}")
    ns_scan.launches += 1
    return mask, consumed, ins, final_ids, n_acc


def ns_scan(live, pool, max_accepts):
    """The consume/insert scan of :func:`ns_scan_plain` over one pool:
    ``live`` (sorted ascending) and ``pool`` 1-D contiguous float32
    tensors on one device, ``max_accepts`` an int (clamped to int32).
    CUDA tensors launch ``csrc/ns_scan.cu`` once; CPU tensors take
    :func:`ns_scan_plain`."""
    _check(live, pool)
    if live.device.type == "cpu":
        return ns_scan_plain(live, pool, max_accepts)
    if live.device.type == "cuda":
        return _launch(live, pool, max_accepts)
    raise RuntimeError(f"ns_scan: no kernel for device {live.device}")


#: Kernel launches since the count was last set to 0.
ns_scan.launches = 0
