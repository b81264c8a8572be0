"""The consume/insert step of nested sampling, replayed one candidate at
a time.

The live set is kept sorted ascending by log-likelihood. Each candidate
of the pool, in the order it is popped, is accepted when it beats the
worst live point (and fewer than ``max_accepts`` were accepted): the
worst point dies, and the candidate goes in at ``idx - 1``, where ``idx``
counts the live points below it. The outputs are those the program's
scan returns: the accept mask, the consumed id of each accept, ``idx -
1`` of every candidate, the final live ids and the number accepted; ids
index ``concat(live, pool)``.

``dtype`` sets the precision of the comparisons: float64 for the
reference, bfloat16 for the control.
"""

import numpy as np
import torch

__all__ = ["replay_scan"]


def _round(values, dtype):
    if dtype == "float64":
        return np.asarray(values, np.float64)
    return torch.as_tensor(np.asarray(values, np.float64)).to(getattr(torch, dtype)).double().numpy()


def replay_scan(live, pool, max_accepts, dtype="float64"):
    live = _round(live, dtype).copy()
    pool = _round(pool, dtype)
    n, k = live.size, pool.size
    ids = np.arange(n, dtype=np.int64)
    mask = np.zeros(k, bool)
    consumed = np.full(k, -1, np.int64)
    ins = np.empty(k, np.int64)
    n_acc = 0
    for j in range(k):
        p = pool[j]
        idx = int(np.count_nonzero(live < p))
        ins[j] = idx - 1
        if p > live[0] and n_acc < max_accepts:
            mask[j] = True
            consumed[j] = ids[0]
            live[: idx - 1] = live[1:idx]
            live[idx - 1] = p
            ids[: idx - 1] = ids[1:idx]
            ids[idx - 1] = n + j
            n_acc += 1
    return mask, consumed, ins, ids, n_acc
