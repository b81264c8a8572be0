"""One round of the flow proposal's rejection sampling, written out
plainly.

A round draws ``B`` latent points ``z0`` from the unit Gaussian and ``B``
uniforms ``u`` from one ``torch.Generator`` (in that order), scales the
draws by the square root of the latent temperature, keeps those inside
the latent radius, maps them through the flow's inverse and then the
reparameterisations' inverses, and accepts a draw where it lies in the
prior's box, its density is finite and ``log u < log w - max log w``
with ``log w = log p(x) - log q(x)``: the prior (a uniform box times the
auxiliary radii's chi priors) over the proposal's density.

The reparameterisations, by kind (the names of the flow's columns follow
the program's naming):

- ``angle`` (parameter ``a``, scale ``s``): ``(a_x, a_y)`` to the radius
  ``a_radial = |(a_x, a_y)|`` and ``a = atan2(a_y, a_x) mod 2 pi / s``,
  ``log|dx/dx'| = -log r``; the radius has a chi(2) prior;
- ``angle_pair`` (``ra``, ``dec``): ``(ra_x, ra_y, ra_z)`` to
  ``ra_radial = r``, ``ra = atan2(y, x) mod 2 pi``, ``dec = atan2(z,
  |(x, y)|)``, ``log|dx/dx'| = -2 log r - log|cos dec|``; chi(3);
- ``affine`` (the remaining parameters ``p``): ``p = p_prime scale +
  shift`` with the scale and shift the proposal holds when the round
  runs, ``log|dx/dx'| = log|scale|``.

The latent radius and the affine scales and shifts are the proposal's
state at the round, set from the live points at its last training and
update; the reference takes them as the round found them.
"""

import math

import numpy as np
import torch

__all__ = ["replay_round", "round_diff"]


def _angle(cols, name, scale):
    cx, cy = cols[f"{name}_x"], cols[f"{name}_y"]
    r = torch.sqrt(cx**2 + cy**2)
    angle = torch.remainder(torch.atan2(cy, cx), 2.0 * math.pi) / scale
    return {name: angle, f"{name}_radial": r}, -torch.log(r), torch.log(r) - 0.5 * r**2


def _angle_pair(cols, names):
    a, b = names
    cx, cy, cz = (cols[f"{a}_{c}"] for c in "xyz")
    rho = torch.sqrt(cx**2 + cy**2)
    r = torch.sqrt(cx**2 + cy**2 + cz**2)
    alpha = torch.remainder(torch.atan2(cy, cx), 2.0 * math.pi)
    beta = torch.atan2(cz, rho)
    log_j = -2.0 * torch.log(r) - torch.log(torch.abs(torch.cos(beta)))
    log_prior = 2.0 * torch.log(r) - 0.5 * r**2 + 0.5 * math.log(2.0 / math.pi)
    return {a: alpha, b: beta, f"{a}_radial": r}, log_j, log_prior


def replay_round(item, flow, kinds, bounds, dtype=torch.float64, device="cpu"):
    """The round recorded in ``item`` (its generator's state, ``B``, the
    squared latent radius ``r2``, ``sqrt_t``, the flow's column names
    ``prime``, the proposal's parameter order ``parameters`` and the
    ``affine`` scales and shifts), through ``flow`` (a
    :class:`~.realnvp.PlainRealNVP` in ``dtype``), with the
    reparameterisations ``kinds`` (``("angle", name, scale)`` or
    ``("angle_pair", (a, b))``) and the prior's ``bounds``. Returns ``(x
    [B, P], accept [B])`` as numpy, x in float64."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.set_state(item["gen_state"])
    prime, params = item["prime"], item["parameters"]
    B = int(item["B"])
    z0 = torch.randn(B, len(prime), generator=gen, device=device).to(dtype)
    log_u = torch.log(torch.rand(B, generator=gen, device=device).to(dtype))
    sqrt_t = float(item["sqrt_t"])
    z = z0 * sqrt_t
    in_ball = torch.sum(z * z, dim=1) <= float(item["r2"])
    x_prime, log_j = flow.inverse_t(z)
    d = z.shape[1]
    log_q = -0.5 * torch.sum(z0 * z0, dim=1) - 0.5 * d * math.log(2 * math.pi) - log_j - d * math.log(sqrt_t)
    cols = {name: x_prime[:, i] for i, name in enumerate(prime)}
    out, log_p = {}, torch.zeros(B, dtype=dtype, device=device)
    for kind in kinds:
        if kind[0] == "angle":
            vals, lj, lp = _angle(cols, kind[1], kind[2])
        elif kind[0] == "angle_pair":
            vals, lj, lp = _angle_pair(cols, kind[1])
        else:
            raise ValueError(f"no reparameterisation of kind {kind[0]!r} here")
        out.update(vals)
        log_q = log_q - lj
        log_p = log_p + lp
    for name, (scale, shift) in item["affine"].items():
        out[name] = cols[f"{name}_prime"] * scale + shift
        log_q = log_q - math.log(abs(scale))
    if sorted(out) != sorted(params):
        raise ValueError(f"the round's parameters {params} are not the reference's {sorted(out)}")
    x = torch.stack([out[p] for p in params], dim=1)
    in_b = torch.ones(B, dtype=torch.bool, device=device)
    for name, (lo, hi) in bounds.items():
        in_b &= (out[name] >= lo) & (out[name] <= hi)
        log_p = log_p - math.log(hi - lo)
    ok = in_ball & in_b & torch.isfinite(log_q)
    log_w = torch.where(ok, log_p - log_q, torch.full_like(log_q, -math.inf))
    accept = ok & (log_u < log_w - torch.max(log_w))
    return x.double().cpu().numpy(), accept.cpu().numpy()


def _scales(params, bounds):
    return np.array([bounds[p][1] - bounds[p][0] if p in bounds else 1.0 for p in params])


def round_diff(rows, count, cap, x_ref, accept_ref, params, bounds, block=512):
    """``(flips, gap)`` of a round's accepted rows against the
    reference's.

    ``rows`` are the rows the round wrote, in order (at most ``cap``),
    ``count`` the accepted draws it counted. Each row is matched to the
    nearest of the reference's ``B`` draws (each column over its prior's
    width); ``flips`` counts the draws that one side accepted and the
    other did not, up to the last row written, the difference of the
    counts past it, and rows whose matches do not rise in order; ``gap``
    is the largest ``|x - x_ref| / (1 + |x_ref|)`` of a row against its
    match."""
    rows = np.asarray(rows, np.float64).reshape(-1, x_ref.shape[1])
    scale = _scales(params, bounds)
    ref = torch.as_tensor(x_ref / scale)
    idx = []
    for s in range(0, len(rows), block):
        d = torch.cdist(torch.as_tensor(rows[s : s + block] / scale), ref, p=float("inf"))
        idx.append(torch.argmin(d, dim=1).numpy())
    idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    ref_idx = np.flatnonzero(accept_ref)
    if len(idx) == 0:
        return int(len(ref_idx)) + int(count), 0.0
    last = int(idx[-1])
    disorder = int(np.count_nonzero(np.diff(idx) <= 0))
    flips = len(np.setxor1d(idx, ref_idx[ref_idx <= last]))
    flips += abs((int(count) - len(idx)) - int(np.count_nonzero(ref_idx > last))) + disorder
    match = x_ref[idx]
    gap = float(np.max(np.abs(rows - match) / (1.0 + np.abs(match))))
    return int(flips), gap
