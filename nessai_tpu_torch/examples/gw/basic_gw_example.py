#!/usr/bin/env python
"""Basic GW example: a frequency-domain compact-binary inspiral injection.

Counterpart of ``examples/gw/basic_gw_example.py``: a Newtonian-order
frequency-domain inspiral (amplitude ``~ Mc^{5/6} f^{-7/6} / d_L``, SPA
phase ``~ (pi Mc f)^{-5/3}``) injected into stationary Gaussian noise in
two detectors, recovered with a Whittle likelihood. The device likelihood
evaluates the whole ``[batch, 2, n_freq]`` template bank in one pass of
real float32 tensor operations, with the observed data passed in through
``torch_likelihood_data``.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gw.basic_gw_example``.
"""

import math

import numpy as np
import torch

from ...model import Model, UniformPriorMixin

OUTPUT = "./outdir/basic_gw_example/"

# ---------------------------------------------------------------------
# Injection: GW150914-like chirp mass, two detectors
# ---------------------------------------------------------------------
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
freqs = np.arange(F_MIN, F_MAX, DF)
#: flat one-sided noise PSD (arbitrary units)
PSD = 1e-2 * np.ones_like(freqs)

TRUE = dict(
    chirp_mass=28.0,  # solar masses (geometric factor absorbed in A0)
    luminosity_distance=400.0,  # Mpc
    phase=1.3,
    geocent_time=0.01,  # s, relative to segment centre
)
#: overall amplitude scale chosen to give SNR ~ 20 at the true distance
A0 = 40.0


def _amp_psi(f, chirp_mass, luminosity_distance, phase, geocent_time, xp):
    amp = A0 * chirp_mass ** (5.0 / 6.0) / luminosity_distance * f ** (-7.0 / 6.0)
    psi = (
        (3.0 / 128.0) * (np.pi * chirp_mass * f / 1000.0) ** (-5.0 / 3.0)
        + 2 * np.pi * f * geocent_time
        - 2 * phase
        - np.pi / 4
    )
    return amp, psi


def _waveform(f, chirp_mass, luminosity_distance, phase, geocent_time, xp):
    """Newtonian-order stationary-phase inspiral (complex strain, host
    numpy only; the device likelihood splits it into re/im)."""
    amp, psi = _amp_psi(f, chirp_mass, luminosity_distance, phase, geocent_time, xp)
    return amp * xp.exp(-1j * psi)


rng_data = np.random.default_rng(170817)
_sigma = np.sqrt(PSD / (4 * DF))
DATA = []
for _det in range(2):
    noise = _sigma * (rng_data.normal(size=freqs.size) + 1j * rng_data.normal(size=freqs.size))
    DATA.append(_waveform(freqs, xp=np, **TRUE) + noise)
DATA = np.asarray(DATA)

#: the device likelihood's data: complex arrays split into real parts
LIKELIHOOD_DATA = {
    "freqs": np.asarray(freqs, np.float32),
    "data_re": np.ascontiguousarray(DATA.real, dtype=np.float32),
    "data_im": np.ascontiguousarray(DATA.imag, dtype=np.float32),
    "inv_psd": np.asarray(1.0 / PSD, np.float32),
}

#: the script's sampler arguments
SAMPLER_KWARGS = dict(
    seed=170817,
    nlive=1000,
    reparameterisations={"phase": {"reparameterisation": "angle-2pi"}},
)


def whittle_log_likelihood(h_re, h_im, data):
    """``-2 df sum |d - h|^2 / S`` over detectors and frequencies of a
    ``[batch, n_det, n_freq]`` template pair (``[batch, n_freq]`` is
    broadcast to every detector)."""
    if h_re.dim() == 2:
        h_re, h_im = h_re[:, None, :], h_im[:, None, :]
    r_re = data["data_re"][None, :, :] - h_re
    r_im = data["data_im"][None, :, :] - h_im
    return -2.0 * DF * torch.sum((r_re**2 + r_im**2) * data["inv_psd"][None, None, :], dim=(-2, -1))


class BasicGWModel(UniformPriorMixin, Model):
    """4-parameter CBC-like model with a Whittle likelihood and uniform box
    priors (the mixin gives the prior and the unit-hypercube maps, so the
    INS example takes this model unchanged)."""

    def __init__(self):
        self.names = ["chirp_mass", "luminosity_distance", "phase", "geocent_time"]
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "luminosity_distance": [100.0, 1000.0],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
        }
        self.torch_likelihood_data = LIKELIHOOD_DATA

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        out = np.zeros(len(x))
        for i, p in enumerate(x):
            h = _waveform(
                freqs, p["chirp_mass"], p["luminosity_distance"], p["phase"], p["geocent_time"], xp=np
            )
            r = DATA - h[None, :]
            out[i] = -2.0 * DF * np.sum(np.abs(r) ** 2 / PSD[None, :])
        return out

    def torch_log_likelihood(self, x, data):
        """The Whittle log-likelihood of a ``[batch, 4]`` float32 tensor,
        in real arithmetic (h = amp e^{-i psi} as cos and sin parts)."""
        mc, dl, phase, tc = (x[:, i : i + 1] for i in range(4))
        f = data["freqs"][None, :]
        amp = A0 * mc ** (5.0 / 6.0) / dl * f ** (-7.0 / 6.0)
        psi = (
            (3.0 / 128.0) * (math.pi * mc * f / 1000.0) ** (-5.0 / 3.0)
            + 2 * math.pi * f * tc
            - 2 * phase
            - math.pi / 4
        )
        return whittle_log_likelihood(amp * torch.cos(psi), -amp * torch.sin(psi), data)


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(BasicGWModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
