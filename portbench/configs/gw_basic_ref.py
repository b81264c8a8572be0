"""Plain reference of the ``gw_basic`` configuration: its injection and
its Whittle log-likelihood.

A Newtonian-order stationary-phase inspiral, amplitude ``A0 Mc^{5/6}
f^{-7/6} / d_L`` and phase ``psi(f) = 3/128 (pi Mc f / 1000)^{-5/3} + 2 pi
f t_c - 2 phi - pi/4``, so ``h = amp e^{-i psi}``, injected at ``TRUE`` into
white Gaussian noise of one-sided PSD ``PSD`` in two detectors drawn from
``numpy.random.default_rng(SEED)`` (the real part, then the imaginary part,
of each detector in turn). The log-likelihood of a template is ``-2 df
sum_{det, f} |d - h|^2 / PSD``.
"""

import math

import numpy as np
import torch

NAMES = ["chirp_mass", "luminosity_distance", "phase", "geocent_time"]
F_MIN, F_MAX, DF = 20.0, 256.0, 0.25
PSD_LEVEL = 1e-2
A0 = 40.0
SEED = 170817
TRUE = dict(chirp_mass=28.0, luminosity_distance=400.0, phase=1.3, geocent_time=0.01)


def _amp_psi(f, mc, dl, phase, tc):
    amp = A0 * mc ** (5.0 / 6.0) / dl * f ** (-7.0 / 6.0)
    psi = (3.0 / 128.0) * (math.pi * mc * f / 1000.0) ** (-5.0 / 3.0) + 2 * math.pi * f * tc - 2 * phase - math.pi / 4
    return amp, psi


def injection():
    """The frequencies, the PSD and the two detectors' data (float64)."""
    freqs = np.arange(F_MIN, F_MAX, DF)
    psd = PSD_LEVEL * np.ones_like(freqs)
    rng = np.random.default_rng(SEED)
    sigma = np.sqrt(psd / (4 * DF))
    amp, psi = _amp_psi(freqs, *(TRUE[n] for n in NAMES))
    h = amp * np.exp(-1j * psi)
    data = []
    for _ in range(2):
        noise = sigma * (rng.normal(size=freqs.size) + 1j * rng.normal(size=freqs.size))
        data.append(h + noise)
    data = np.asarray(data)
    return dict(freqs=freqs, psd=psd, data_re=data.real, data_im=data.imag)


def log_likelihood(x, dtype=torch.float64, device="cpu", block=4096):
    """The log-likelihood of the rows of ``x`` (``[n, 4]`` in the order of
    ``NAMES``), computed in ``dtype``, in blocks of ``block`` rows;
    returns float64 numpy."""
    inj = injection()
    t = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in inj.items()}
    f = t["freqs"][None, :]
    x = np.asarray(x, np.float64)
    out = []
    for s in range(0, len(x), block):
        xb = torch.as_tensor(x[s : s + block], device=device).to(dtype)
        mc, dl, phase, tc = (xb[:, i : i + 1] for i in range(4))
        amp = A0 * mc ** (5.0 / 6.0) / dl * f ** (-7.0 / 6.0)
        psi = (3.0 / 128.0) * (math.pi * mc * f / 1000.0) ** (-5.0 / 3.0) + 2 * math.pi * f * tc - 2 * phase - math.pi / 4
        h_re, h_im = amp * torch.cos(psi), -amp * torch.sin(psi)
        r_re = t["data_re"][None] - h_re[:, None, :]
        r_im = t["data_im"][None] - h_im[:, None, :]
        out.append(-2.0 * DF * torch.sum((r_re**2 + r_im**2) / t["psd"][None, None, :], dim=(-2, -1)))
    return torch.cat(out).double().cpu().numpy()


#: the prior's box (uniform in each parameter)
BOUNDS = {
    "chirp_mass": (20.0, 40.0),
    "luminosity_distance": (100.0, 1000.0),
    "phase": (0.0, 2 * math.pi),
    "geocent_time": (-0.1, 0.1),
}
#: the reparameterisations of the flow's space other than the affine one
#: the remaining parameters take: ``phase`` as an angle on [0, 2 pi]
KINDS = [("angle", "phase", 1.0)]
