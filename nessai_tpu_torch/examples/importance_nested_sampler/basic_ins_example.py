#!/usr/bin/env python
"""The importance nested sampler on the 2-D Rosenbrock likelihood on
[-5, 5]^2, nlive 2000, with ``draw_constant=True`` (nlive new samples at
every level).

Counterpart of ``examples/importance_nested_sampler/basic_ins_example.py``;
the model is :class:`nessai_tpu_torch.utils.testing.RosenbrockModel`
(with the unit-hypercube maps the importance nested sampler needs).
Log-evidence: :func:`~nessai_tpu_torch.utils.testing.rosenbrock_log_evidence`
at 2 dimensions.

Run on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.basic_ins_example``.
"""

import os

from ...utils.testing import RosenbrockModel

OUTPUT = os.path.join("outdir", "basic_ins_example")

#: the dimensions of the script's model
DIMS = 2

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(nlive=2000, seed=1234, importance_nested_sampler=True, draw_constant=True)

__all__ = ["DIMS", "OUTPUT", "RosenbrockModel", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(RosenbrockModel(DIMS), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
