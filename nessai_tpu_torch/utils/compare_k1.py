"""Hold this checkout's K1 kernels against another checkout's on one GPU.

Run from the root of this checkout on a machine with a CUDA GPU, with
the other checkout (for example the parent commit, unpacked with
``git archive``) at ``OTHER``::

    python -m nessai_tpu_torch.utils.compare_k1 OTHER

Both packages are loaded in one process, each building its own kernels
into its own ``_build/``. For the bare transform
(``ops.coupling.affine_coupling``) and for ``flows.bijectors.AffineCoupling``
layers with the same weights in both, it prints one JSON line per shape:
whether the outputs, and for the layers the gradients of the input and
of every weight, are bitwise equal, and the GPU time per call of each
version's kernel launch (the bare transform) or of its layer forward and
backward, measured in turns (other, this, this, other).
"""

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..flows import bijectors
from ..ops import coupling
from .profiling import device_time_ms

__all__ = ["load_other", "compare"]

#: bare transform shapes [n, d] and layer shapes (n, mask)
BARE_SHAPES = [(900, 1), (100, 1), (13, 3), (1000, 8), (4096, 3), (257, 5), (65536, 16)]
LAYER_SHAPES = [(900, (1, 0)), (900, (0, 1)), (13, (1, 0, 0, 1, 0)), (4096, (1, 0) * 4), (65536, (1, 0) * 16)]
#: shapes whose times are taken (the others are checked only)
TIMED = {(900, 1), (65536, 16), (900, (1, 0)), (65536, (1, 0) * 16)}


def load_other(root):
    """The ``nessai_tpu_torch`` package of the checkout at ``root``, loaded
    as ``_other_nessai_tpu_torch`` beside this one."""
    path = Path(root).resolve() / "nessai_tpu_torch"
    name = "_other_nessai_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py", submodule_search_locations=[str(path)]
    )
    package = importlib.util.module_from_spec(spec)
    sys.modules[name] = package
    spec.loader.exec_module(package)
    return package


def _in_turns(other, this):
    """GPU ms per call of ``other`` and ``this`` as other, this, this, other."""
    times = [device_time_ms(f)[0] for f in (other, this, this, other)]
    return dict(other_ms=[times[0], times[3]], this_ms=[times[1], times[2]])


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _bare(other_coupling, gen):
    for n, d in BARE_SHAPES:
        x, t = (torch.randn(n, d, device="cuda", generator=gen) for _ in range(2))
        raw = 2.0 * torch.randn(n, d, device="cuda", generator=gen)
        row = dict(kind="bare", n=n, d=d)
        for inverse in (False, True):
            with torch.no_grad():
                mine = coupling.affine_coupling(x, raw, t, inverse)
                theirs = other_coupling.affine_coupling(x, raw, t, inverse)
            row["inverse" if inverse else "forward"] = _equal(mine, theirs)
        if (n, d) in TIMED:
            row["forward_time"] = _in_turns(
                lambda: other_coupling._launch(x, raw, t, False, 5.0),
                lambda: coupling._launch(x, raw, t, False, 5.0),
            )
        yield row


def _layer(other_bijectors, n, mask, gen):
    """The two versions' AffineCoupling with the same perturbed weights,
    the input and the cotangents."""
    layers = [bijectors.AffineCoupling(mask, n_neurons=16).cuda()]
    layers.append(other_bijectors.AffineCoupling(mask, n_neurons=16).cuda())
    with torch.no_grad():
        for p in layers[0].parameters():
            p.add_(0.3 * torch.randn(p.shape, device="cuda", generator=gen))
    layers[1].load_state_dict(layers[0].state_dict())
    x = torch.randn(n, len(mask), device="cuda", generator=gen)
    cot = (torch.randn(n, len(mask), device="cuda", generator=gen), torch.randn(n, device="cuda", generator=gen))
    return layers, x, cot


def _grads(layer, x, cot, inverse):
    xg = x.clone().requires_grad_(True)
    out = (layer.inverse if inverse else layer)(xg)
    params = list(layer.parameters())
    return out, torch.autograd.grad(out, [xg, *params], cot)


def _layers(other_bijectors, gen):
    for n, mask in LAYER_SHAPES:
        layers, x, cot = _layer(other_bijectors, n, mask, gen)
        row = dict(kind="layer", n=n, mask=list(mask))
        for inverse in (False, True):
            (mine, g_mine), (theirs, g_theirs) = (_grads(m, x, cot, inverse) for m in layers)
            tag = "inverse" if inverse else "forward"
            row[tag] = _equal(mine, theirs)
            row[f"{tag}_gradients"] = _equal(g_mine, g_theirs)
        if (n, mask) in TIMED:
            with torch.no_grad():
                row["forward_time"] = _in_turns(lambda: layers[1](x), lambda: layers[0](x))
            inputs = [[x.clone().requires_grad_(True), *m.parameters()] for m in layers]
            mine, theirs = (m(i[0]) for m, i in zip(layers, inputs))
            row["backward_time"] = _in_turns(
                lambda: torch.autograd.grad(theirs, inputs[1], cot, retain_graph=True),
                lambda: torch.autograd.grad(mine, inputs[0], cot, retain_graph=True),
            )
        yield row


def compare(other_root):
    """Every comparison, one dict per shape."""
    other = load_other(other_root)
    other_coupling = importlib.import_module(f"{other.__name__}.ops.coupling")
    other_bijectors = importlib.import_module(f"{other.__name__}.flows.bijectors")
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    yield from _bare(other_coupling, gen)
    yield from _layers(other_bijectors, gen)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("comparing the K1 kernels needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    print(json.dumps(dict(card=card, other=sys.argv[1])), flush=True)
    for row in compare(sys.argv[1]):
        print(json.dumps(row), flush=True)
