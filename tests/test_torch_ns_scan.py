"""The nested-sampling consume/insert scan of the port
(``nessai_tpu_torch/ops/ns_scan.py``, ``samplers/ns_device.py``) against
the JAX package's ``scan_consume`` / ``run_ns_scan``
(``nessai_tpu/samplers/ns_device.py``) and the pure-python oracle of
``tests/test_device_ns_loop.py``: all five outputs equal, exactly, over
seeds, ties, -inf padding, accept caps and pools that accept nothing,
and over the regimes and live-set sizes the kernel's design branches on
(``csrc/ns_scan.cu``: rejections in bulk, accepted steps, the capped
tail; the block's shapes and where it holds the live set).
The CUDA kernel against the plain version is in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nessai_tpu.samplers.ns_device import run_ns_scan as jax_run_ns_scan
from nessai_tpu.samplers.ns_device import scan_consume
from nessai_tpu_torch.ops.ns_scan import ns_scan, ns_scan_plain
from nessai_tpu_torch.ops.ns_scan import (
    REGISTER_MAX_LIVE,
    SHARED_MAX_LIVE,
    SHARED_VALUES_MAX_LIVE,
    block_shape,
    memory_path,
)
from nessai_tpu_torch.samplers.ns_device import run_ns_scan
from nessai_tpu_torch.utils.testing import ns_scan_case
from tests.test_device_ns_loop import _oracle

UNBOUNDED = 2**31 - 1


@pytest.fixture(autouse=True)
def _threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _inputs(seed, n, k, ties=False, pad=0):
    rng = np.random.default_rng(seed)
    live = np.sort(rng.normal(size=n)).astype(np.float32)
    pool = rng.normal(loc=float(live[n // 5]), scale=2.0, size=k).astype(np.float32)
    if ties:
        # candidates equal to live values (the worst among them) and to each other
        live = np.sort(np.round(live, 1)).astype(np.float32)
        pool = np.round(pool, 1).astype(np.float32)
        pool[::5] = live[0]
        pool[1::7] = live[n // 2]
    if pad:
        pool[-pad:] = -np.inf
    return live, pool


def _plain(live, pool, max_accepts):
    out = ns_scan_plain(torch.from_numpy(live), torch.from_numpy(pool), max_accepts)
    return [o.numpy() for o in out[:4]] + [int(out[4])]


def _jax(live, pool, max_accepts):
    out = jax.jit(scan_consume)(jnp.asarray(live), jnp.asarray(pool), jnp.int32(max_accepts))
    return [np.asarray(o) for o in out[:4]] + [int(out[4])]


@pytest.mark.parametrize(
    "seed, n, k, ties, pad, max_accepts",
    [
        (0, 32, 100, False, 0, UNBOUNDED),
        (1, 32, 100, False, 0, UNBOUNDED),
        (2, 64, 128, True, 0, UNBOUNDED),
        (3, 64, 128, True, 17, UNBOUNDED),
        (4, 50, 100, False, 0, 17),
        (5, 50, 100, True, 9, 17),
        (6, 200, 256, False, 0, 3),
    ],
)
def test_plain_scan_equals_jax_scan_consume(seed, n, k, ties, pad, max_accepts):
    """mask, consumed ids, insertion indices (every step's, accepted or
    not), final ids and the accept count, bit for bit."""
    live, pool = _inputs(seed, n, k, ties=ties, pad=pad)
    ours = _plain(live, pool, max_accepts)
    theirs = _jax(live, pool, max_accepts)
    for a, b, name in zip(ours, theirs, ("mask", "consumed", "ins", "final_ids", "n_acc")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert ours[0].dtype == np.bool_ and ours[1].dtype == np.int32 and ours[3].dtype == np.int32


@pytest.mark.parametrize("seed, ties, max_accepts", [(0, False, None), (1, True, None), (2, True, 10), (3, False, 1)])
def test_plain_scan_equals_the_oracle(seed, ties, max_accepts):
    """Against the pure-python replica of the JAX package's tests."""
    live, pool = _inputs(seed, 40, 90, ties=ties)
    mask, consumed, ins, ids_f, n_acc = _plain(live, pool, UNBOUNDED if max_accepts is None else max_accepts)
    emask, econs, eins, eids, enacc = _oracle(live.astype(np.float64), pool.astype(np.float64), max_accepts)
    assert n_acc == enacc
    assert mask.tolist() == emask
    assert consumed.tolist() == econs
    assert ids_f.tolist() == eids
    assert [i for i, m in zip(ins.tolist(), mask.tolist()) if m] == [i for i in eins if i is not None]


def test_scan_all_skips():
    """A pool below the worst live point accepts nothing and leaves the
    ids as they were, in both packages."""
    live = np.linspace(10.0, 11.0, 8).astype(np.float32)
    pool = np.full(20, 5.0, np.float32)
    for mask, consumed, ins, ids_f, n_acc in (_plain(live, pool, 100), _jax(live, pool, 100)):
        assert n_acc == 0 and not np.asarray(mask).any()
        assert np.asarray(ids_f).tolist() == list(range(8))
        assert (np.asarray(consumed) == -1).all() and (np.asarray(ins) == -1).all()


@pytest.mark.parametrize("k", [100, 64, 300])
@pytest.mark.parametrize("max_accepts", [UNBOUNDED, 5])
def test_run_ns_scan_buckets_as_the_jax_package(k, max_accepts):
    """``run_ns_scan`` pads the pool with -inf to ``_bucket_size(K, 64)``
    and cuts the outputs back to K; the five outputs equal those of the
    JAX package's ``run_ns_scan``."""
    live, pool = _inputs(k, 48, k)
    ours = run_ns_scan(live, pool, max_accepts, device="cpu")
    theirs = jax_run_ns_scan(live, pool, max_accepts)
    assert [len(ours[0]), len(ours[1]), len(ours[2])] == [k, k, k]
    for a, b in zip(ours[:4], theirs[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[4] == theirs[4]


def test_wrapper_checks_and_takes_the_plain_version_on_the_cpu():
    live, pool = _inputs(0, 16, 40)
    live_t, pool_t = torch.from_numpy(live), torch.from_numpy(pool)
    before = ns_scan.launches
    out = ns_scan(live_t, pool_t, UNBOUNDED)
    assert ns_scan.launches == before
    for a, b in zip(out, ns_scan_plain(live_t, pool_t, UNBOUNDED)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="float32"):
        ns_scan(live_t.double(), pool_t, 5)
    with pytest.raises(ValueError, match="1-D"):
        ns_scan(live_t[:, None], pool_t, 5)
    with pytest.raises(ValueError, match="contiguous"):
        ns_scan(live_t, torch.from_numpy(np.repeat(pool, 2))[::2], 5)
    with pytest.raises(ValueError, match="empty"):
        ns_scan(live_t[:0], pool_t, 5)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ns_scan(live_t.to("meta"), pool_t.to("meta"), 5)


#: (regime, nlive, K, max_accepts): the regimes of the kernel's design at
#: small sizes, then each side of every change of its shape
#: (``block_shape``: 8, 16 or 32 entries a lane in one warp, 16 a thread in
#: several, 32 a thread in the rings or more) and of ``memory_path``
REGIME_CASES = [
    ("terminal", 64, 300, UNBOUNDED),
    ("terminal", 200, 1200, 17),
    ("ascending", 48, 100, UNBOUNDED),
    ("ascending", 40, 90, 33),
    ("mixed", 50, 100, 0),
    ("mixed", 50, 100, 1),
    ("mixed", 50, 100, 5),
    ("nan_inf", 64, 150, UNBOUNDED),
    ("nan_inf", 64, 150, 17),
    ("ties", 80, 160, UNBOUNDED),
    ("ties", 80, 160, 9),
] + [
    ("mixed", n, k, cap)
    for n, k, cap in [
        (1, 40, UNBOUNDED), (256, 40, UNBOUNDED), (257, 40, UNBOUNDED),
        (512, 40, UNBOUNDED), (513, 40, UNBOUNDED),
        (1024, 40, UNBOUNDED), (1025, 40, UNBOUNDED), (1025, 40, 3),
        (REGISTER_MAX_LIVE, 40, UNBOUNDED), (REGISTER_MAX_LIVE + 1, 40, UNBOUNDED), (REGISTER_MAX_LIVE + 1, 40, 3),
        (32 * 1024, 8, UNBOUNDED), (32 * 1024 + 1, 8, UNBOUNDED),
        (SHARED_MAX_LIVE, 8, UNBOUNDED), (SHARED_MAX_LIVE + 1, 8, UNBOUNDED), (SHARED_MAX_LIVE + 1, 8, 2),
        (SHARED_VALUES_MAX_LIVE, 8, UNBOUNDED), (SHARED_VALUES_MAX_LIVE + 1, 8, 2),
    ]
]


@pytest.mark.parametrize("regime, n, k, max_accepts", REGIME_CASES)
def test_scan_regimes_and_paths_in_both_packages(regime, n, k, max_accepts):
    """Each regime and each side of each path boundary: the plain scan
    equals the JAX package's ``scan_consume`` in all five outputs and the
    oracle, and ``run_ns_scan`` the JAX package's, bit for bit. The case
    is in the regime it names (every step accepted, a few candidates
    above the worst, the cap reached in the first chunk of 32, ...)."""
    live, pool = ns_scan_case(regime, n, k, seed=n + k)
    ours = _plain(live, pool, max_accepts)
    for a, b, name in zip(ours, _jax(live, pool, max_accepts), ("mask", "consumed", "ins", "final_ids", "n_acc")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    mask, consumed, ins, ids_f, n_acc = ours
    emask, econs, eins, eids, enacc = _oracle(live.astype(np.float64), pool.astype(np.float64), max_accepts)
    assert (n_acc, mask.tolist(), consumed.tolist(), ids_f.tolist()) == (enacc, emask, econs, eids)
    assert [i for i, m in zip(ins.tolist(), mask.tolist()) if m] == [i for i in eins if i is not None]
    ran = run_ns_scan(live, pool, max_accepts, device="cpu")
    theirs = jax_run_ns_scan(live, pool, max_accepts)
    assert all(np.array_equal(a, b) for a, b in zip(ran[:4], theirs[:4])) and ran[4] == theirs[4] == n_acc
    # the regime itself
    above = int((pool > live[0]).sum())
    if regime == "ascending":
        assert n_acc == min(k, max_accepts) and mask[:n_acc].all()
    elif regime == "terminal":
        assert 0 < n_acc <= above <= max(1, k // 400)
    elif regime == "nan_inf":
        nan = np.isnan(pool)
        assert nan.any() and np.isinf(pool).any() and not mask[nan].any() and (ins[nan] == -1).all()
    elif regime == "ties":
        tied = pool == live[0]
        assert tied.sum() >= 5 * (k // 8) and not mask[tied].any()
    if 0 < max_accepts <= 5:
        assert n_acc == max_accepts and np.nonzero(mask)[0][-1] < 32
    if max_accepts == 0:
        assert n_acc == 0 and (consumed == -1).all() and (ins >= -1).all() and (ins > -1).any()
    # ins is the lower bound of every step, accepted or not, over the live set
    # as the step found it: after the cap, over the frozen set
    if n_acc == max_accepts and n_acc < k:
        frozen = np.where(ids_f < n, live[np.minimum(ids_f, n - 1)], pool[np.maximum(ids_f - n, 0)])
        last = np.nonzero(mask)[0][-1] if n_acc else -1
        tail = pool[last + 1 :]
        # the count sum(live < p): 0 for NaN, where searchsorted puts NaN last
        below = np.where(np.isnan(tail), 0, np.searchsorted(frozen, tail, side="left"))
        assert ins[last + 1 :].tolist() == (below - 1).tolist()
    threads, per_thread = block_shape(n)
    assert threads % 32 == 0 and threads * per_thread >= n
    assert memory_path(n) in ("register", "shared", "global_ids", "global")
