"""Plain reference of the ``gw_full`` configuration: its injection and its
Whittle log-likelihood.

A restricted-1PN stationary-phase inspiral with inclination,
polarisation and sky location. With ``eta = q / (1 + q)^2``, ``M = Mc /
eta^{3/5}``, ``v^2 = (pi M f / 1000)^{2/3}``, the phase is ``psi(f) = 3/128
(pi Mc f / 1000)^{-5/3} (1 + 20/9 (743/336 + 11 eta / 4) v^2) - 2 phi -
pi/4`` and the amplitude ``A0 Mc^{5/6} f^{-7/6} / d_L``. Detector ``d``
sees ``F+ = a_d cos(2 psi_pol + 2 (ra + r_d)) cos(dec)``, ``Fx = a_d
sin(2 psi_pol + 2 (ra + r_d))``, the arrival time ``t_c + dt_d sin(dec)``
and ``h = amp (F+ (1 + cos^2 i) / 2 - i Fx cos i) e^{-i (psi - 2 pi f
t_d)}``. The injection at ``TRUE`` adds white Gaussian noise of one-sided
PSD ``PSD_LEVEL`` drawn from ``numpy.random.default_rng(SEED)``: all real
parts (``[2, n_freq]``), then all imaginary parts. The log-likelihood is
``-2 df sum_{det, f} |d - h|^2 / PSD``.
"""

import math

import numpy as np
import torch

NAMES = [
    "chirp_mass",
    "mass_ratio",
    "luminosity_distance",
    "theta_jn",
    "psi",
    "phase",
    "geocent_time",
    "ra",
    "dec",
]
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
PSD_LEVEL = 1e-2
A0 = 40.0
SEED = 150914
DET_AMP = (1.0, 0.9)
DET_RA_OFF = (0.0, 0.7)
DET_DT = (0.0, 0.01)
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


def _template(f, p, xp):
    """The two detectors' strain as ``(re, im)``, each ``[..., 2, n_freq]``;
    ``xp`` is numpy or torch."""
    pi = math.pi
    mc, q = p["chirp_mass"], p["mass_ratio"]
    eta = q / (1.0 + q) ** 2
    mtot = mc / eta ** (3.0 / 5.0)
    amp = A0 * mc ** (5.0 / 6.0) / p["luminosity_distance"] * f ** (-7.0 / 6.0)
    v2 = (pi * mtot * f / 1000.0) ** (2.0 / 3.0)
    psi_f = (
        (3.0 / 128.0) * (pi * mc * f / 1000.0) ** (-5.0 / 3.0) * (1.0 + (20.0 / 9.0) * (743.0 / 336.0 + 11.0 * eta / 4.0) * v2)
        - 2.0 * p["phase"]
        - pi / 4
    )
    ci = xp.cos(p["theta_jn"])
    a_plus, a_cross = 0.5 * (1.0 + ci**2), ci
    re, im = [], []
    for d in range(2):
        fp = DET_AMP[d] * xp.cos(2.0 * p["psi"] + 2.0 * (p["ra"] + DET_RA_OFF[d])) * xp.cos(p["dec"])
        fx = DET_AMP[d] * xp.sin(2.0 * p["psi"] + 2.0 * (p["ra"] + DET_RA_OFF[d]))
        t_d = p["geocent_time"] + DET_DT[d] * xp.sin(p["dec"])
        phase_d = psi_f - 2.0 * pi * f * t_d
        c, s = xp.cos(phase_d), xp.sin(phase_d)
        re.append(amp * (fp * a_plus * c - fx * a_cross * s))
        im.append(amp * (-fp * a_plus * s - fx * a_cross * c))
    stack = np.stack if xp is np else torch.stack
    kw = dict(axis=-2) if xp is np else dict(dim=-2)
    return stack(re, **kw), stack(im, **kw)


def injection():
    """The frequencies, the PSD and the two detectors' data (float64)."""
    freqs = np.arange(F_MIN, F_MAX, DF)
    psd = PSD_LEVEL * np.ones_like(freqs)
    rng = np.random.default_rng(SEED)
    sigma = np.sqrt(psd / (4 * DF))
    h_re, h_im = _template(freqs[None, :], {k: np.float64(v) for k, v in TRUE.items()}, np)
    data_re = h_re[0] + sigma * rng.normal(size=(2, freqs.size))
    data_im = h_im[0] + sigma * rng.normal(size=(2, freqs.size))
    return dict(freqs=freqs, psd=psd, data_re=data_re, data_im=data_im)


def log_likelihood(x, dtype=torch.float64, device="cpu", block=4096):
    """The log-likelihood of the rows of ``x`` (``[n, 9]`` in the order of
    ``NAMES``), computed in ``dtype``, in blocks of ``block`` rows;
    returns float64 numpy."""
    inj = injection()
    t = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in inj.items()}
    f = t["freqs"][None, :]
    x = np.asarray(x, np.float64)
    out = []
    for s in range(0, len(x), block):
        xb = torch.as_tensor(x[s : s + block], device=device).to(dtype)
        p = {n: xb[:, i : i + 1] for i, n in enumerate(NAMES)}
        h_re, h_im = _template(f, p, torch)
        r_re = t["data_re"][None] - h_re
        r_im = t["data_im"][None] - h_im
        out.append(-2.0 * DF * torch.sum((r_re**2 + r_im**2) / t["psd"][None, None, :], dim=(-2, -1)))
    return torch.cat(out).double().cpu().numpy()


#: the prior's box (uniform in each parameter)
BOUNDS = {
    "chirp_mass": (20.0, 40.0),
    "mass_ratio": (0.25, 1.0),
    "luminosity_distance": (100.0, 1000.0),
    "theta_jn": (0.0, math.pi),
    "psi": (0.0, math.pi),
    "phase": (0.0, 2 * math.pi),
    "geocent_time": (-0.1, 0.1),
    "ra": (0.0, 2 * math.pi),
    "dec": (-math.pi / 2, math.pi / 2),
}
#: the reparameterisations of the flow's space other than the affine one
#: the remaining parameters take: ``phase`` on [0, 2 pi] and ``psi`` on
#: [0, pi] (an angle of scale 2) as angles, ``(ra, dec)`` as a sky pair
KINDS = [("angle", "phase", 1.0), ("angle", "psi", 2.0), ("angle_pair", ("ra", "dec"))]
