"""Hold this checkout's scan kernel against another checkout's on one GPU.

Run from the root of this checkout on a machine with a CUDA GPU, with
the other checkout (for example the parent commit, unpacked with
``git archive``) at ``OTHER``::

    python -m nessai_tpu_torch.utils.compare_scan OTHER

Both packages are loaded in one process, each building its kernels into
its own ``_build/``. Over the rows of ``chip_smoke.py``'s
``ns_scan_vs_plain`` (:func:`~nessai_tpu_torch.utils.testing.ns_scan_rows`),
it prints one JSON line per row: whether the five outputs of the two
versions' ``ns_scan`` are bitwise equal, and the GPU time per pool of
each, measured in turns (other, this, this, other).
"""

import importlib
import json
import subprocess
import sys

import torch

from ..ops.ns_scan import memory_path, ns_scan
from .compare_k1 import load_other
from .profiling import device_time_ms
from .testing import ns_scan_rows

__all__ = ["compare"]

#: calls per timing: PR 11's kernel takes up to ~23 ms a pool
CALLS = 10


def _in_turns(other, this):
    """GPU ms per call of ``other`` and ``this`` as other, this, this, other."""
    times = [device_time_ms(f, calls=CALLS, warmup=2)[0] for f in (other, this, this, other)]
    return dict(other_ms=[times[0], times[3]], this_ms=[times[1], times[2]])


def compare(other_root):
    """Every row's comparison, one dict each."""
    other = load_other(other_root)
    other_scan = importlib.import_module(f"{other.__name__}.ops.ns_scan")
    for spec, live, pool in ns_scan_rows("cuda"):
        cap = spec["max_accepts"]
        mine = ns_scan(live, pool, cap)
        theirs = other_scan.ns_scan(live, pool, cap)
        torch.cuda.synchronize()
        times = _in_turns(lambda: other_scan.ns_scan(live, pool, cap), lambda: ns_scan(live, pool, cap))
        yield dict(
            spec,
            memory=memory_path(spec["nlive"]),
            accepted=int(mine[4]),
            bitwise_equal=all(torch.equal(a, b) for a, b in zip(mine, theirs)),
            **times,
            speedup=min(times["other_ms"]) / max(times["this_ms"]),
        )


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("comparing the scan kernels needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    print(json.dumps(dict(card=card, other=sys.argv[1], calls=CALLS)), flush=True)
    rows = []
    for row in compare(sys.argv[1]):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if not all(r["bitwise_equal"] for r in rows):
        raise SystemExit("the two versions' outputs differ")
