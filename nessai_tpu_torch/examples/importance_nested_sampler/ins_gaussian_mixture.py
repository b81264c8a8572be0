#!/usr/bin/env python
"""The importance nested sampler on an equal mixture of two unit
Gaussians at (4, 4) and (-4, -4) on [-10, 10]^2, nlive 2000, stopping
once both the evidence ratio (0) and the effective sample size (3000)
criteria are met, then redrawing to a posterior ESS of 2000.

Counterpart of ``examples/importance_nested_sampler/ins_gaussian_mixture.py``;
the model is :class:`nessai_tpu_torch.utils.testing.GaussianMixture`.
Analytic log-evidence: ``-2 log 20``.

Run on the GPU with
``python -m nessai_tpu_torch.examples.importance_nested_sampler.ins_gaussian_mixture``.
"""

from ...utils.testing import GaussianMixture

OUTPUT = "./outdir/ins_gaussian_mixture/"

#: the dimensions of the script's model
DIMS = 2

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(
    importance_nested_sampler=True,
    seed=1234,
    nlive=2000,
    stopping_criterion=["ratio", "ess"],
    tolerance=[0.0, 3000],
    check_criteria="all",
)
#: the script's arguments of ``run``: the final redraw
RUN_KWARGS = dict(redraw_samples=True, n_posterior_samples=2000)

__all__ = ["DIMS", "GaussianMixture", "OUTPUT", "RUN_KWARGS", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(GaussianMixture(DIMS), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run(**RUN_KWARGS)
