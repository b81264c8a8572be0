#!/usr/bin/env python
"""Full GW example: a 9-parameter CBC-like injection with sky location.

Counterpart of ``examples/gw/full_gw_example.py``: a restricted-1PN
frequency-domain inspiral with inclination, polarisation and sky
location, observed by two detectors with toy antenna responses and a
relative time delay, recovered with a Whittle likelihood over the
``[batch, 2, n_freq]`` template bank. The sky angles take the angle-pair
('ra-dec') reparameterisation, the phase and polarisation the angle ones,
so the flow's space has 12 dimensions.

Run on the GPU with ``python -m nessai_tpu_torch.examples.gw.full_gw_example``.
"""

import math

import numpy as np
import torch

from ...model import Model, UniformPriorMixin
from .basic_gw_example import whittle_log_likelihood

OUTPUT = "./outdir/full_gw_example/"

# ---------------------------------------------------------------------
# Injection: GW150914-like masses, two detectors with toy responses
# ---------------------------------------------------------------------
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
freqs = np.arange(F_MIN, F_MAX, DF)
PSD = 1e-2 * np.ones_like(freqs)

#: per-detector antenna constants (toy L-shaped responses): the +/x
#: patterns are F+ = a cos(2 psi + 2 ra_off) cos(dec), F_x = a sin(2 psi +
#: 2 ra_off), a simple analytic stand-in for the full geocentric geometry
DET_AMP = np.array([1.0, 0.9])
DET_RA_OFF = np.array([0.0, 0.7])
#: light-travel-time baseline between the detectors (s)
DET_DT = np.array([0.0, 0.01])

TRUE = dict(
    chirp_mass=28.0,
    mass_ratio=0.85,
    luminosity_distance=400.0,
    theta_jn=0.6,
    psi=1.2,
    phase=1.3,
    geocent_time=0.01,
    ra=1.375,
    dec=-0.5,
)
A0 = 40.0


def _template(f, p, xp):
    """Restricted-1PN SPA strain at each detector, split into re/im, with
    shapes ``(..., n_det, n_freq)`` (host numpy)."""
    mc = p["chirp_mass"]
    q = p["mass_ratio"]
    eta = q / (1.0 + q) ** 2
    mtot = mc / eta ** (3.0 / 5.0)
    amp = A0 * mc ** (5.0 / 6.0) / p["luminosity_distance"] * f ** (-7.0 / 6.0)
    v2 = (xp.pi * mtot * f / 1000.0) ** (2.0 / 3.0)
    psi_f = (
        (3.0 / 128.0)
        * (xp.pi * mc * f / 1000.0) ** (-5.0 / 3.0)
        * (1.0 + (20.0 / 9.0) * (743.0 / 336.0 + 11.0 * eta / 4.0) * v2)
        - 2.0 * p["phase"]
        - xp.pi / 4
    )
    ci = xp.cos(p["theta_jn"])
    a_plus = 0.5 * (1.0 + ci**2)
    a_cross = ci
    out_re, out_im = [], []
    for d in range(2):
        fp = DET_AMP[d] * xp.cos(2.0 * p["psi"] + 2.0 * (p["ra"] + DET_RA_OFF[d])) * xp.cos(p["dec"])
        fx = DET_AMP[d] * xp.sin(2.0 * p["psi"] + 2.0 * (p["ra"] + DET_RA_OFF[d]))
        # arrival time at this detector (toy delay ~ sin(dec))
        t_d = p["geocent_time"] + DET_DT[d] * xp.sin(p["dec"])
        phase_d = psi_f - 2.0 * xp.pi * f * t_d
        # h = (F+ a+ - i Fx ax) * amp * e^{-i phase_d}
        c, s = xp.cos(phase_d), xp.sin(phase_d)
        out_re.append(amp * (fp * a_plus * c - fx * a_cross * s))
        out_im.append(amp * (-fp * a_plus * s - fx * a_cross * c))
    return xp.stack(out_re, axis=-2), xp.stack(out_im, axis=-2)


def _torch_template(f, p):
    """:func:`_template` in float32 tensor operations: ``f`` is
    ``[1, n_freq]``, each parameter ``[batch, 1]``; returns
    ``[batch, 2, n_freq]`` re/im parts."""
    mc = p["chirp_mass"]
    q = p["mass_ratio"]
    eta = q / (1.0 + q) ** 2
    mtot = mc / eta ** (3.0 / 5.0)
    amp = A0 * mc ** (5.0 / 6.0) / p["luminosity_distance"] * f ** (-7.0 / 6.0)
    v2 = (math.pi * mtot * f / 1000.0) ** (2.0 / 3.0)
    psi_f = (
        (3.0 / 128.0)
        * (math.pi * mc * f / 1000.0) ** (-5.0 / 3.0)
        * (1.0 + (20.0 / 9.0) * (743.0 / 336.0 + 11.0 * eta / 4.0) * v2)
        - 2.0 * p["phase"]
        - math.pi / 4
    )
    ci = torch.cos(p["theta_jn"])
    a_plus = 0.5 * (1.0 + ci**2)
    a_cross = ci
    out_re, out_im = [], []
    for d in range(2):
        fp = float(DET_AMP[d]) * torch.cos(2.0 * p["psi"] + 2.0 * (p["ra"] + float(DET_RA_OFF[d]))) * torch.cos(p["dec"])
        fx = float(DET_AMP[d]) * torch.sin(2.0 * p["psi"] + 2.0 * (p["ra"] + float(DET_RA_OFF[d])))
        t_d = p["geocent_time"] + float(DET_DT[d]) * torch.sin(p["dec"])
        phase_d = psi_f - 2.0 * math.pi * f * t_d
        c, s = torch.cos(phase_d), torch.sin(phase_d)
        out_re.append(amp * (fp * a_plus * c - fx * a_cross * s))
        out_im.append(amp * (-fp * a_plus * s - fx * a_cross * c))
    return torch.stack(out_re, dim=-2), torch.stack(out_im, dim=-2)


rng_data = np.random.default_rng(150914)
_sigma = np.sqrt(PSD / (4 * DF))
_h_re, _h_im = _template(freqs[None, :], {k: np.float64(v) for k, v in TRUE.items()}, np)
DATA_RE = _h_re[0] + _sigma * rng_data.normal(size=(2, freqs.size))
DATA_IM = _h_im[0] + _sigma * rng_data.normal(size=(2, freqs.size))

LIKELIHOOD_DATA = {
    "freqs": np.asarray(freqs, np.float32),
    "data_re": np.asarray(DATA_RE, np.float32),
    "data_im": np.asarray(DATA_IM, np.float32),
    "inv_psd": np.asarray(1.0 / PSD, np.float32),
}

#: the script's sampler arguments
SAMPLER_KWARGS = dict(
    seed=150914,
    nlive=2000,
    flow_config=dict(n_blocks=6, n_neurons=32),
    reparameterisations={
        "phase": {"reparameterisation": "angle-2pi"},
        "psi": {"reparameterisation": "angle-pi"},
        "sky": {"reparameterisation": "angle-pair", "parameters": ["ra", "dec"]},
    },
)


class FullGWModel(UniformPriorMixin, Model):
    """9-parameter CBC-like model with sky location."""

    def __init__(self):
        self.names = list(TRUE.keys())
        self.bounds = {
            "chirp_mass": [20.0, 40.0],
            "mass_ratio": [0.25, 1.0],
            "luminosity_distance": [100.0, 1000.0],
            "theta_jn": [0.0, np.pi],
            "psi": [0.0, np.pi],
            "phase": [0.0, 2 * np.pi],
            "geocent_time": [-0.1, 0.1],
            "ra": [0.0, 2 * np.pi],
            "dec": [-np.pi / 2, np.pi / 2],
        }
        self.torch_likelihood_data = LIKELIHOOD_DATA

    def _params(self, x):
        return {n: x[..., i : i + 1] for i, n in enumerate(self.names)}

    def log_likelihood(self, x):
        x = np.atleast_1d(x)
        u = self.unstructured_view(x).reshape(len(x), -1)
        p = self._params(u)
        h_re, h_im = _template(freqs[None, None, :], {k: v[..., None] for k, v in p.items()}, np)
        r_re = DATA_RE[None, :, :] - h_re[:, 0]
        r_im = DATA_IM[None, :, :] - h_im[:, 0]
        return -2.0 * DF * np.sum((r_re**2 + r_im**2) / PSD[None, None, :], axis=(-2, -1))

    def torch_log_likelihood(self, x, data):
        """The Whittle likelihood over ``[batch, 2, n_freq]`` templates of
        a ``[batch, 9]`` float32 tensor, in real arithmetic."""
        h_re, h_im = _torch_template(data["freqs"][None, :], self._params(x))
        return whittle_log_likelihood(h_re, h_im, data)


if __name__ == "__main__":
    from ...flowsampler import FlowSampler
    from ...utils import configure_logger

    configure_logger(output=OUTPUT)
    FlowSampler(FullGWModel(), output=OUTPUT, resume=False, **SAMPLER_KWARGS).run()
