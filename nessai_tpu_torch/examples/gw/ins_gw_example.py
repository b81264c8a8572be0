#!/usr/bin/env python
"""GW example with the importance nested sampler.

Counterpart of ``examples/gw/ins_gw_example.py``: the injection of
``basic_gw_example`` sampled with ``importance_nested_sampler=True``, the
final posterior samples redrawn from the meta-proposal.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gw.ins_gw_example``.
"""

from .basic_gw_example import BasicGWModel

OUTPUT = "./outdir/ins_gw_example/"

#: the script's sampler arguments and those of its ``run``
SAMPLER_KWARGS = dict(seed=151226, nlive=2000, importance_nested_sampler=True)
RUN_KWARGS = dict(redraw_samples=True, n_posterior_samples=2000)


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    fs = FlowSampler(BasicGWModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS)
    fs.run(**RUN_KWARGS)
    print(f"logZ = {fs.logZ:.3f} +/- {fs.log_evidence_error:.3f}")
    print(f"posterior samples: {len(fs.posterior_samples)}")
