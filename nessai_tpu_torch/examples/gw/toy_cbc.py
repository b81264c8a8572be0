#!/usr/bin/env python
"""Toy compact-binary-like (chirp) injection with a device likelihood.

Counterpart of ``examples/gw/toy_cbc.py``: a frequency-evolving sinusoid
("chirp") under a Gaussian envelope, injected into white Gaussian noise on
1024 time samples and recovered with a Gaussian likelihood. The device
likelihood evaluates the ``[batch, n_samples]`` waveform bank in one pass.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gw.toy_cbc``.
"""

import math

import numpy as np
import torch

from ...model import Model

OUTPUT = "./outdir/toy_cbc/"

# ---------------------------------------------------------------------
# Injection
# ---------------------------------------------------------------------
T, FS = 4.0, 256.0
t_grid = np.arange(0, T, 1 / FS)
TRUE = dict(amp=1.0, f0=20.0, fdot=5.0, phi0=1.0, tau=1.5)
SIGMA_NOISE = 0.5


def waveform_np(t, amp, f0, fdot, phi0, tau):
    phase = 2 * np.pi * (f0 * t + 0.5 * fdot * t**2) + phi0
    return amp * np.exp(-((t - T / 2) ** 2) / (2 * tau**2)) * np.sin(phase)


rng_data = np.random.default_rng(1234)
data = waveform_np(t_grid, **TRUE) + SIGMA_NOISE * rng_data.normal(size=t_grid.size)

LIKELIHOOD_DATA = {"t": np.asarray(t_grid, np.float32), "data": np.asarray(data, np.float32)}

#: the script's sampler arguments
SAMPLER_KWARGS = dict(
    seed=1234,
    nlive=2000,
    reparameterisations={"phi0": {"reparameterisation": "angle-2pi"}},
)


class ToyCBCModel(Model):
    def __init__(self):
        self.names = ["amp", "f0", "fdot", "phi0", "tau"]
        self.bounds = {
            "amp": [0.1, 3.0],
            "f0": [10.0, 30.0],
            "fdot": [0.0, 10.0],
            "phi0": [0.0, 2 * np.pi],
            "tau": [0.5, 3.0],
        }
        self.torch_likelihood_data = LIKELIHOOD_DATA

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype="float")
        for n in self.names:
            log_p -= np.log(np.ptp(self.bounds[n]))
        return log_p

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        out = np.zeros(len(x))
        for i, p in enumerate(x):
            h = waveform_np(t_grid, p["amp"], p["f0"], p["fdot"], p["phi0"], p["tau"])
            out[i] = -0.5 * np.sum((data - h) ** 2) / SIGMA_NOISE**2
        return out

    def torch_log_likelihood(self, x, data):
        """The Gaussian log-likelihood of a ``[batch, 5]`` float32 tensor:
        the ``[batch, n_samples]`` waveform bank in one pass."""
        amp, f0, fdot, phi0, tau = (x[:, i : i + 1] for i in range(5))
        t = data["t"][None, :]
        phase = 2 * math.pi * (f0 * t + 0.5 * fdot * t**2) + phi0
        h = amp * torch.exp(-((t - T / 2) ** 2) / (2 * tau**2)) * torch.sin(phase)
        return -0.5 * torch.sum((data["data"][None, :] - h) ** 2, dim=-1) / SIGMA_NOISE**2


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(ToyCBCModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
