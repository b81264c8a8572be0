#!/usr/bin/env python
"""The importance nested sampler on a 4-D unit Gaussian on a uniform prior
on [-10, 10]^4, nlive 2000.

Counterpart of ``examples/importance_nested_sampler/ins_gaussian.py``;
its model, with the unit-hypercube maps, is
:class:`nessai_tpu_torch.utils.testing.IntegrationTestModel`. Analytic
log-evidence: ``-4 log 20``.

Run on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.ins_gaussian``.
"""

from ...utils.testing import IntegrationTestModel as GaussianModel

OUTPUT = "./outdir/ins_gaussian/"

#: the dimensions of the script's model
DIMS = 4

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(importance_nested_sampler=True, seed=1234, nlive=2000)

__all__ = ["DIMS", "GaussianModel", "OUTPUT", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(GaussianModel(DIMS), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
