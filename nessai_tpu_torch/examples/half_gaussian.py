#!/usr/bin/env python
"""A half-normal in x on [0, 10], whose density piles up at its lower
bound, and a unit normal in y on [-10, 10]: x takes the boundary
inversion (edge detection, the split inversion), y the default rescaling.

Counterpart of ``examples/half_gaussian.py``; the model is
:class:`nessai_tpu_torch.utils.testing.HalfGaussianModel`. Analytic
log-evidence: ``-log 200``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.half_gaussian``.
"""

from ..utils.testing import HalfGaussianModel

OUTPUT = "./outdir/half_gaussian/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, reparameterisations={"x": "inversion", "y": "default"})

__all__ = ["HalfGaussianModel", "OUTPUT", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(HalfGaussianModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
