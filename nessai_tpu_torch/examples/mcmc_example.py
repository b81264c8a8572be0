#!/usr/bin/env python
"""The MCMC flow proposal: the 2-D unit normal on [-10, 10]^2 (host
likelihood and prior), each populate 20 differential-evolution steps in
the flow's latent space.

Counterpart of ``examples/mcmc_example.py``; the model is
:class:`nessai_tpu_torch.utils.testing.GaussianModel`. Analytic
log-evidence: ``-log 400``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.mcmc_example``.
"""

from ..utils.testing import GaussianModel

OUTPUT = "./outdir/mcmc/"

#: the script's sampler arguments (its output and ``resume=False`` apart)
SAMPLER_KWARGS = dict(seed=1234, flow_class="mcmcflowproposal", n_steps=20, step_type="diff")

__all__ = ["GaussianModel", "OUTPUT", "SAMPLER_KWARGS"]

if __name__ == "__main__":
    from ..flowsampler import FlowSampler
    from ..utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(GaussianModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
