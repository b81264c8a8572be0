#!/usr/bin/env python
"""The Rosenbrock likelihood in 5 dimensions on a uniform prior on
[-5, 5]^5, with the flow configuration the script demonstrates: a
RealNVP of 4 couplings whose nets have 3 layers of 10 neurons.

Counterpart of ``examples/rosenbrock.py``; the model is
:class:`nessai_tpu_torch.utils.testing.RosenbrockModel`. Log-evidence:
:func:`~nessai_tpu_torch.utils.testing.rosenbrock_log_evidence` at 5
dimensions (transfer matrices).

Run on the GPU with ``python -m nessai_tpu_torch.examples.rosenbrock``.
"""

from ..utils.testing import RosenbrockModel

OUTPUT = "./outdir/rosenbrock/"

#: the dimensions of the script's model
DIMS = 5

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(flow_config=dict(n_blocks=4, n_neurons=10, n_layers=3), seed=1451)

__all__ = ["DIMS", "OUTPUT", "RosenbrockModel", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(RosenbrockModel(DIMS), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
