#!/usr/bin/env python
"""The angle reparameterisation: a von Mises angle (kappa 2 about pi) on
[0, 2 pi] through ``angle-2pi`` (Cartesian coordinates with an auxiliary
radius, three prime dimensions), and a normal amplitude N(2, 0.5) on
[0, 5] through the default rescaling.

Counterpart of ``examples/reparameterisations_example.py``; the model is
:class:`nessai_tpu_torch.utils.testing.AngleModel`. Analytic log-evidence:
``log(Phi(6) - Phi(-4)) - log(10 pi)``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.reparameterisations_example``.
"""

from ..utils.testing import AngleModel

OUTPUT = "./outdir/reparameterisations/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, reparameterisations={"theta": {"reparameterisation": "angle-2pi"}, "amp": "default"})

__all__ = ["AngleModel", "OUTPUT", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(AngleModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
