#!/usr/bin/env python
"""GW example with a host likelihood standing in for a device one.

Counterpart of ``examples/gw/callback_gw_example.py``. Real GW likelihoods
usually call lalsuite (C extensions) and cannot run as tensor operations.
``likelihood_callback = True`` lets the host ``log_likelihood`` serve
where the sampler asks for a device likelihood: it is evaluated on the
host on the accepted draws (or, where a truncation rule needs it, on every
row of the populate's device call). The waveform here is numpy only
(standing in for lalsuite), on the data of ``basic_gw_example``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gw.callback_gw_example``.
"""

import numpy as np

from ...model import Model
from .basic_gw_example import DATA, DF, PSD, _waveform, freqs

OUTPUT = "./outdir/callback_gw_example/"

#: the script's sampler arguments (the default z-score
#: reparameterisation)
SAMPLER_KWARGS = dict(seed=170817, nlive=1000)


class LalStyleGWModel(Model):
    """The Whittle likelihood of :class:`BasicGWModel`, on the host only
    (vectorised numpy standing in for a lalsuite call)."""

    #: let the host likelihood stand in for a device likelihood
    likelihood_callback = True
    #: the numpy implementation below is vectorised over the batch
    allow_vectorised = True

    def __init__(self):
        self.names = ["chirp_mass", "luminosity_distance", "phase", "geocent_time"]
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "luminosity_distance": [100.0, 1000.0],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
        }

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        mc = np.asarray(x["chirp_mass"], float)[:, None]
        dl = np.asarray(x["luminosity_distance"], float)[:, None]
        phase = np.asarray(x["phase"], float)[:, None]
        tc = np.asarray(x["geocent_time"], float)[:, None]
        h = _waveform(freqs[None, :], mc, dl, phase, tc, xp=np)
        r = DATA[None, :, :] - h[:, None, :]
        return -2.0 * DF * np.sum(np.abs(r) ** 2 / PSD[None, None, :], axis=(-2, -1))


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(LalStyleGWModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
