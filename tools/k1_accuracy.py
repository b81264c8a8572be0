"""K1's distance from the float64 function beside the float32 plain
version's, over many random inputs, on one GPU.

The coupling layer's kernel and its plain PyTorch version both round in
float32; ``chip_smoke.py`` (``k1_layer_vs_plain``) holds the kernel's
distance from the same function computed in float64 on the same inputs
to a multiple of the plain version's (``float64_distances``). This
script measures, over fresh inputs of each shape, how the two
statistics that function reports are spread::

    python tools/k1_accuracy.py [TRIALS]

It prints one JSON line per shape and direction: the quantiles of the
kernel-to-plain ratio of the largest absolute distance (dominated by the
one or two elements of largest |y|, where an ulp of s moves y by y times
that ulp) and of the mean scaled distance ``|y - y64| / max(|y64|, 1)``
over every element, with the share of trials where each ratio exceeds 2.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: (n, D, mask; 1 marks an identity column): the flagship's coupling, a
#: width with 16-byte loads, and the GW examples' training batches
SHAPES = [
    (900, 2, (1, 0)),
    (1000, 8, (1, 0) * 4),
    (900, 5, (0, 1, 0, 1, 0)),
    (900, 5, (1, 0, 1, 0, 1)),
    (1000, 12, (0, 1) * 6),
    (1000, 12, (1, 0) * 6),
]


def study(shapes=SHAPES, trials: int = 300, seed: int = 7) -> list:
    """The two ratios' spread over ``trials`` fresh inputs of each shape
    (x and t standard normal, raw_s twice that), forward and inverse."""
    from chip_smoke import float64_distances
    from nessai_tpu_torch.ops import coupling

    rows = []
    for n, D, mask in shapes:
        tidx = torch.tensor([i for i, m in enumerate(mask) if not m], dtype=torch.int32, device="cuda")
        n_tr = tidx.numel()
        for inverse in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            ratios = {"max_abs": [], "mean_scaled": []}
            for _ in range(trials):
                x = torch.randn(n, D, device="cuda", generator=gen)
                out = torch.randn(n, 2 * n_tr, device="cuda", generator=gen)
                out[:, :n_tr] *= 2.0
                with torch.no_grad():
                    y, _ = coupling.affine_coupling_layer(x, out, tidx, inverse)
                    y_plain, _ = coupling.affine_coupling_layer_plain(x, out, tidx, inverse)
                    y64, _ = coupling.affine_coupling_layer_plain(x.double(), out.double(), tidx, inverse)
                d = float64_distances(y, y_plain, y64)
                for key in ratios:
                    ratios[key].append(d[key] / d[f"plain_{key}"])
            row = dict(n=n, D=D, mask=list(mask), inverse=inverse, trials=trials)
            for key, values in ratios.items():
                v = torch.tensor(values, dtype=torch.float64)
                q = torch.tensor([0.01, 0.5, 0.99], dtype=torch.float64)
                row[f"{key}_ratio_quantiles"] = torch.quantile(v, q).tolist()
                row[f"{key}_ratio_max"] = float(v.max())
                row[f"{key}_ratio_share_over_2"] = float((v > 2.0).double().mean())
            rows.append(row)
    return rows


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k1_accuracy needs a CUDA GPU")
    for row in study(trials=int(sys.argv[1]) if len(sys.argv) > 1 else 300):
        print(json.dumps(row), flush=True)
