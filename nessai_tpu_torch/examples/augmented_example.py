#!/usr/bin/env python
"""The augmented flow proposal: an equal mixture of two unit Gaussians at
(-5, -5) and (5, 5) on [-10, 10]^2, sampled with two unit-Gaussian
augment dimensions (a 4-D flow with the fixed coupling mask).

Counterpart of ``examples/augmented_example.py`` (its model is called
``GaussianMixtureModel`` there); the model is
:class:`nessai_tpu_torch.utils.testing.BimodalGaussianModel`. Analytic
log-evidence: ``-log 400``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.augmented_example``.
"""

from ..utils.testing import BimodalGaussianModel

OUTPUT = "./outdir/augmented/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, flow_class="augmentedflowproposal", augment_dims=2)

__all__ = ["BimodalGaussianModel", "OUTPUT", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(BimodalGaussianModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
