#!/usr/bin/env python
"""GW example with calibration uncertainty.

Counterpart of ``examples/gw/calibration_example.py``: the detector
response carries an uncertain frequency-dependent amplitude calibration,
modelled by per-detector nodes interpolated linearly in log f across the
band, which are sampled alongside the source parameters with truncated
Gaussian priors. The device likelihood evaluates the waveform, the
envelopes and the Whittle likelihood over the ``[batch, 2, n_freq]`` bank
in one pass; the prior stays on the host.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gw.calibration_example``.
"""

import math

import numpy as np
import torch
from scipy.stats import norm

from ...model import Model
from .basic_gw_example import whittle_log_likelihood

OUTPUT = "./outdir/calibration_example/"

# ---------------------------------------------------------------------
# Injection (same base waveform as basic_gw_example)
# ---------------------------------------------------------------------
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
freqs = np.arange(F_MIN, F_MAX, DF)
PSD = 1e-2 * np.ones_like(freqs)
A0 = 40.0

N_NODES = 3  # amplitude calibration nodes per detector
NODE_FREQS = np.geomspace(F_MIN, F_MAX - DF, N_NODES)
CAL_SIGMA = 0.05  # Gaussian prior scale on the node amplitudes

TRUE = dict(
    chirp_mass=28.0,
    luminosity_distance=400.0,
    phase=1.3,
    geocent_time=0.01,
)
#: injected calibration offsets (within ~1 sigma of the prior)
TRUE_CAL = {
    f"recalib_d{d}_amplitude_{i}": v
    for d, vals in enumerate([(0.04, -0.02, 0.03), (-0.03, 0.05, 0.0)])
    for i, v in enumerate(vals)
}


def _amp_psi(f, chirp_mass, luminosity_distance, phase, geocent_time, xp):
    amp = A0 * chirp_mass ** (5.0 / 6.0) / luminosity_distance * f ** (-7.0 / 6.0)
    psi = (
        (3.0 / 128.0) * (xp.pi * chirp_mass * f / 1000.0) ** (-5.0 / 3.0)
        + 2 * xp.pi * f * geocent_time
        - 2 * phase
        - xp.pi / 4
    )
    return amp, psi


def _envelope(f, nodes, xp):
    """1 + dA(f): the amplitude calibration envelope interpolated linearly
    in log f from the node values (host numpy)."""
    return 1.0 + xp.interp(xp.log(f), np.log(NODE_FREQS), nodes)


rng_data = np.random.default_rng(150914)
_sigma = np.sqrt(PSD / (4 * DF))
DATA_RE, DATA_IM = [], []
for d in range(2):
    amp, psi = _amp_psi(freqs, xp=np, **TRUE)
    nodes = np.array([TRUE_CAL[f"recalib_d{d}_amplitude_{i}"] for i in range(N_NODES)])
    amp = amp * _envelope(freqs, nodes, np)
    DATA_RE.append(amp * np.cos(psi) + _sigma * rng_data.normal(size=freqs.size))
    DATA_IM.append(-amp * np.sin(psi) + _sigma * rng_data.normal(size=freqs.size))
DATA_RE, DATA_IM = np.asarray(DATA_RE), np.asarray(DATA_IM)

LIKELIHOOD_DATA = {
    "freqs": np.asarray(freqs, np.float32),
    "data_re": np.asarray(DATA_RE, np.float32),
    "data_im": np.asarray(DATA_IM, np.float32),
    "inv_psd": np.asarray(1.0 / PSD, np.float32),
    "log_nodes": np.asarray(np.log(NODE_FREQS), np.float32),
}

#: the script's sampler arguments
SAMPLER_KWARGS = dict(
    seed=150914,
    nlive=1000,
    flow_config=dict(n_blocks=6, n_neurons=32),
    reparameterisations={"phase": {"reparameterisation": "angle-2pi"}},
)


def interp(x, xp, fp):
    """``np.interp(x, xp, fp[b])`` for every row ``b`` of ``fp``: ``x`` a
    ``[n]`` tensor, ``xp`` the ``[k]`` increasing nodes, ``fp`` ``[batch,
    k]``. Linear between the nodes and clamped to the end values outside
    them, as ``np.interp``; returns ``[batch, n]``."""
    k = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, k - 2)
    x0, x1 = xp[i], xp[i + 1]
    w = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    f0, f1 = fp[:, i], fp[:, i + 1]
    return f0 + w[None, :] * (f1 - f0)


class CalibratedGWModel(Model):
    """4 source parameters and 6 calibration nuisance parameters; the
    nodes' priors are truncated Gaussians, so the prior is not a uniform
    box."""

    def __init__(self):
        self.names = list(TRUE.keys()) + list(TRUE_CAL.keys())
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "luminosity_distance": [100.0, 1000.0],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
        }
        for n in TRUE_CAL:
            self.bounds[n] = [-4 * CAL_SIGMA, 4 * CAL_SIGMA]
        self.torch_likelihood_data = LIKELIHOOD_DATA

    def log_prior(self, x):
        log_p = np.log(self.in_bounds(x), dtype=float)
        for n in TRUE.keys():
            log_p -= np.log(np.ptp(self.bounds[n]))
        for n in TRUE_CAL:
            log_p += norm.logpdf(x[n], scale=CAL_SIGMA)
        return log_p

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        u = self.unstructured_view(x).reshape(len(x), -1).astype(np.float64)
        f = freqs[None, :]
        amp0, psi = _amp_psi(f, u[:, 0:1], u[:, 1:2], u[:, 2:3], u[:, 3:4], xp=np)
        logf, ln = np.log(freqs), np.log(NODE_FREQS)
        h_re, h_im = [], []
        for d in range(2):
            nodes = u[:, 4 + d * N_NODES : 4 + (d + 1) * N_NODES]
            env = 1.0 + np.stack([np.interp(logf, ln, nodes[b]) for b in range(len(u))])
            h_re.append(amp0 * env * np.cos(psi))
            h_im.append(-amp0 * env * np.sin(psi))
        r_re = DATA_RE[None, :, :] - np.stack(h_re, axis=-2)
        r_im = DATA_IM[None, :, :] - np.stack(h_im, axis=-2)
        return -2.0 * DF * np.sum((r_re**2 + r_im**2) / PSD[None, None, :], axis=(-2, -1))

    def torch_log_likelihood(self, x, data):
        """The Whittle likelihood of a ``[batch, 10]`` float32 tensor, the
        envelopes by :func:`interp` on log f."""
        f = data["freqs"][None, :]
        mc, dl, phase, tc = (x[:, i : i + 1] for i in range(4))
        amp0 = A0 * mc ** (5.0 / 6.0) / dl * f ** (-7.0 / 6.0)
        psi = (
            (3.0 / 128.0) * (math.pi * mc * f / 1000.0) ** (-5.0 / 3.0)
            + 2 * math.pi * f * tc
            - 2 * phase
            - math.pi / 4
        )
        logf = torch.log(data["freqs"])
        h_re, h_im = [], []
        for d in range(2):
            nodes = x[:, 4 + d * N_NODES : 4 + (d + 1) * N_NODES]
            amp = amp0 * (1.0 + interp(logf, data["log_nodes"], nodes))
            h_re.append(amp * torch.cos(psi))
            h_im.append(-amp * torch.sin(psi))
        return whittle_log_likelihood(torch.stack(h_re, dim=-2), torch.stack(h_im, dim=-2), data)


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(CalibratedGWModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
