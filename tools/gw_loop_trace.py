"""The device populate loop of the full GW example, traced in either package.

Runs ``examples/gw/full_gw_example.py``'s configuration (D = 12 in the
flow's space, nlive 2000, a 6 x 32 flow) to ``MAX_ITERATION`` in the JAX
package or in the port, on the host CPU, and records at each training of
the flow: the sampler's iteration, and since the last training the device
loop's calls, its rounds, the latent draws, the accepted draws and their
acceptance. The counters are wrapped around each package's populate from
outside; neither package is edited::

    python tools/gw_loop_trace.py jax|torch [SEED] [MAX_ITERATION|none] [DEVICE]

The port runs on the CPU unless ``DEVICE`` names another (``cuda``: its
run on the card, where its kernels launch); the JAX package always runs on
the CPU.

Prints one JSON line a training, then a summary line with logZ, the
iterations, the likelihood evaluations and the seconds. To set two such
outputs side by side, in bins of ``BIN`` iterations (1000 by default)::

    python tools/gw_loop_trace.py compare JAX.log PORT.log [BIN]

prints, for each bin and side, the trainings, the populates, the loop's
calls, its rounds, the draws and their acceptance of the populates that
ended in the bin, then the two summary lines. Both sides start
from the example's seed (150914 unless given) and its arguments
(``nessai_tpu_torch.examples.gw.full_gw_example.SAMPLER_KWARGS``).
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "gw"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


class _Counts:
    """Running totals of the populates, and one row a training."""

    def __init__(self):
        self.fetches = self.draws = self.accepted = self.populates = 0
        #: the device loop's calls so far, as the package counts them
        self.calls_fn = lambda: self.fetches
        self.mark = dict(calls=0, draws=0, accepted=0, populates=0)
        self.sampler = None
        self.batch = None
        self.in_loop = False
        self.rows = []

    def training(self):
        it = int(self.sampler.iteration) if self.sampler is not None else 0
        row = dict(iteration=it)
        now = dict(populates=self.populates, calls=self.calls_fn(), draws=self.draws, accepted=self.accepted)
        for k, v in now.items():
            row[k] = v - self.mark[k]
            self.mark[k] = v
        row["rounds"] = row["draws"] // self.batch if self.batch else None
        row["acceptance"] = row["accepted"] / row["draws"] if row["draws"] else None
        self.rows.append(row)
        print(json.dumps(dict(training=len(self.rows), **row)), flush=True)


COUNTS = _Counts()


def _wrap_populate(cls, batch_of):
    original = cls._device_loop_populate

    def traced(self, n_samples):
        COUNTS.in_loop = True
        try:
            acc, prop, with_ll = original(self, n_samples)
        finally:
            COUNTS.in_loop = False
        COUNTS.populates += 1
        COUNTS.draws += int(prop)
        COUNTS.accepted += int(acc)
        COUNTS.batch = batch_of(self)
        return acc, prop, with_ll

    cls._device_loop_populate = traced


def _wrap_train(cls):
    original = cls.train

    def traced(self, x, plot=True):
        COUNTS.training()
        return original(self, x, plot=plot)

    cls.train = traced


def run_jax(kwargs):
    import jax

    import nessai_tpu.utils.transfer as transfer
    from nessai_tpu.flowmodel.base import _bucket_size
    from nessai_tpu.flowsampler import FlowSampler
    from nessai_tpu.proposal.flowproposal.base import BaseFlowProposal
    from nessai_tpu.proposal.flowproposal.flowproposal import FlowProposal

    from full_gw_example import FullGWModel

    fetch = transfer.arrays_to_host

    def counted(*arrays):
        # the device loop fetches its outputs once a call
        COUNTS.fetches += COUNTS.in_loop
        return fetch(*arrays)

    transfer.arrays_to_host = counted
    _wrap_populate(FlowProposal, lambda p: _bucket_size(int(p.drawsize) if p.drawsize else 4 * p._poolsize))
    _wrap_train(BaseFlowProposal)
    model = FullGWModel()
    with tempfile.TemporaryDirectory() as output, jax.default_device(jax.devices("cpu")[0]):
        fs = FlowSampler(model, output=output, resume=False, plot=False, checkpointing=False, **kwargs)
        COUNTS.sampler = fs.ns
        fs.run(plot=False, save=False)
    return fs, model


def run_torch(kwargs, device="cpu"):
    import torch

    from nessai_tpu_torch.examples.gw.full_gw_example import FullGWModel
    from nessai_tpu_torch.flowsampler import FlowSampler
    from nessai_tpu_torch.proposal.flowproposal import flowproposal
    from nessai_tpu_torch.proposal.flowproposal.base import BaseFlowProposal
    from nessai_tpu_torch.utils.sampling import _bucket_size

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _wrap_populate(
        flowproposal.FlowProposal, lambda p: _bucket_size(int(p.drawsize) if p.drawsize else 4 * p._poolsize)
    )
    _wrap_train(BaseFlowProposal)
    counts = flowproposal.device_loop_counts
    start_calls = counts.calls
    COUNTS.calls_fn = lambda: counts.calls - start_calls
    model = FullGWModel()
    with tempfile.TemporaryDirectory() as output:
        fs = FlowSampler(model, output=output, resume=False, plot=False, checkpointing=False, device=device, **kwargs)
        COUNTS.sampler = fs.ns
        fs.run(plot=False, save=False)
    return fs, model


def _read(path):
    rows, summary = [], None
    with open(path) as f:
        for line in f:
            if line.startswith('{"training"'):
                rows.append(json.loads(line))
            elif line.startswith('{"side"'):
                summary = json.loads(line)
    return rows, summary


def compare(paths, width=1000):
    """The rows of two outputs of this tool, binned by iteration."""
    sides = [_read(p) for p in paths]
    # a row's counts are those of the populates before its training: bin
    # them by the iteration at which that training (or the run) came
    top = max(r["iteration"] for rows, _ in sides for r in rows)
    for start in range(0, top + 1, width):
        out = dict(iterations=[start, start + width])
        names = [summary["side"] if summary else name for (_, summary), name in zip(sides, ("a", "b"))]
        if names[0] == names[1]:
            names = [f"{n}_{i}" for i, n in enumerate(names)]
        for (rows, summary), name in zip(sides, names):
            inside = [r for r in rows if start <= r["iteration"] < start + width]
            tot = {k: sum(r[k] for r in inside) for k in ("populates", "calls", "draws", "accepted")}
            tot["rounds"] = sum(r["rounds"] or 0 for r in inside)
            tot["trainings"] = sum(1 for r in inside if r is not rows[-1])
            tot["acceptance"] = tot["accepted"] / tot["draws"] if tot["draws"] else None
            out[name] = tot
        print(json.dumps(out))
    for _, summary in sides:
        if summary is not None:
            print(json.dumps(summary))


def main(argv):
    from nessai_tpu_torch.examples.gw.full_gw_example import SAMPLER_KWARGS

    side = argv[0]
    if side == "compare":
        return compare(argv[1:3], *(int(a) for a in argv[3:4]))
    kwargs = dict(SAMPLER_KWARGS)
    if len(argv) > 1:
        kwargs["seed"] = int(argv[1])
    if len(argv) > 2 and argv[2] != "none":
        kwargs["max_iteration"] = int(argv[2])
    device = argv[3] if len(argv) > 3 else "cpu"
    start = time.perf_counter()
    if side == "jax":
        fs, model = run_jax(kwargs)
    elif side == "torch":
        fs, model = run_torch(kwargs, device)
    else:
        raise SystemExit(f"unknown side {side!r}: jax or torch")
    COUNTS.training()  # the tail after the last training
    print(
        json.dumps(
            dict(
                side=side,
                device=device if side == "torch" else "cpu",
                seed=kwargs["seed"],
                max_iteration=kwargs.get("max_iteration"),
                logZ=float(fs.logZ),
                logZ_err=float(fs.logZ_error),
                iterations=int(fs.ns.iteration),
                likelihood_evaluations=int(model.likelihood_evaluations),
                trainings=len(COUNTS.rows) - 1,
                seconds=time.perf_counter() - start,
            )
        ),
        flush=True,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
