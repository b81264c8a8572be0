#!/usr/bin/env python
"""The importance nested sampler with a flow on the unit hypercube: the
4-D Rosenbrock likelihood on [-5, 5]^4, nlive 10,000 drawn at every level,
no logit map (the flow sees the hypercube), a quantile threshold at 0.66,
fresh weights every 4 levels, and a neural spline flow of 4 couplings
(8 bins, ``tails=None`` on [0, 1]) on a uniform base, with no linear
transform and no ActNorm.

Counterpart of ``examples/importance_nested_sampler/nsf_unit_hypercube.py``;
the model is :class:`nessai_tpu_torch.utils.testing.RosenbrockModel`.
Log-evidence: :func:`~nessai_tpu_torch.utils.testing.rosenbrock_log_evidence`
(-15.1016907).

Run on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.nsf_unit_hypercube``.
"""

import os

from ...utils.testing import RosenbrockModel

OUTPUT = os.path.join("outdir", "nsf_unit_hypercube")

#: the dimensions of the script's model
DIMS = 4

#: the script's flow
FLOW_CONFIG = dict(
    n_blocks=4,
    n_neurons=32,
    ftype="nsf",
    distribution="uniform",
    linear_transform=None,
    batch_norm_between_layers=False,
    tail_bound=1.0,
    tails=None,
    num_bins=8,
)

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(
    nlive=10000,
    seed=1234,
    importance_nested_sampler=True,
    draw_constant=True,
    reparameterisation=None,
    threshold_kwargs={"q": 0.66},
    reset_flow=4,
    flow_config=FLOW_CONFIG,
)

__all__ = ["DIMS", "FLOW_CONFIG", "OUTPUT", "RosenbrockModel", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT, log_level="INFO")
    FlowSampler(RosenbrockModel(DIMS), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
