#!/usr/bin/env python
"""The egg-box likelihood, (2 + cos(x / 2) cos(y / 2))^5 on [0, 10 pi]^2,
18 peaks: nlive 2000, a full reset of the flow (weights and
permutations) at every 8th training.

Counterpart of ``examples/eggbox.py``; the model is
:class:`nessai_tpu_torch.utils.testing.EggboxModel`. Log-evidence:
:func:`~nessai_tpu_torch.utils.testing.eggbox_log_evidence` (235.85594).

Run on the GPU with ``python -m nessai_tpu_torch.examples.eggbox``.
"""

from ..utils.testing import EggboxModel

OUTPUT = "./outdir/eggbox/"

#: the dimensions of the script's model
DIMS = 2

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=170817, nlive=2000, reset_flow=8)

__all__ = ["DIMS", "EggboxModel", "OUTPUT", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(EggboxModel(DIMS), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
