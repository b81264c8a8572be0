"""Bijectors as ``nn.Module``s. Counterpart of
``nessai_tpu/flows/bijectors.py`` (the RealNVP and neural-spline subset:
``Chain``, ``Permutation``, ``AffineCoupling``, ``RQSCoupling``,
``ActNorm``).

``forward(x)`` maps data to latent and ``inverse(z)`` latent to data;
both return ``(output, log_det)`` with ``log_det`` the per-row log of
the Jacobian determinant of the applied direction.
"""

import numpy as np
import torch
from torch import nn

from ..ops.coupling import affine_coupling_layer
from .nets import MLP, ResNet
from .rqs import rational_quadratic_spline

__all__ = ["Chain", "Permutation", "AffineCoupling", "RQSCoupling", "ActNorm"]


class Chain(nn.Module):
    """Composition; ``forward`` applies the bijectors in order."""

    def __init__(self, bijectors):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)

    def forward(self, x):
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for b in self.bijectors:
            x, ld = b(x)
            log_det = log_det + ld
        return x, log_det

    def inverse(self, z):
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for b in reversed(self.bijectors):
            z, ld = b.inverse(z)
            log_det = log_det + ld
        return z, log_det


class Permutation(nn.Module):
    """Fixed permutation of the columns (volume preserving)."""

    def __init__(self, dim: int, permutation=None, generator=None):
        super().__init__()
        self.dim = dim
        if permutation is None:
            perm = torch.randperm(dim, generator=generator)
        else:
            perm = torch.as_tensor(np.asarray(permutation), dtype=torch.long)
        self.register_buffer("perm", perm)
        self.register_buffer("inv", torch.argsort(perm))

    def forward(self, x):
        return x[:, self.perm], torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def inverse(self, z):
        return z[:, self.inv], torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


class _Coupling(nn.Module):
    """The split of a coupling layer: the identity half (``mask > 0``)
    feeds a conditioner net with ``n_out`` outputs, which parameterise
    the transform of the other half."""

    def __init__(self, mask, n_out_per_dim, n_neurons, n_layers, net, activation, generator):
        super().__init__()
        mask = np.asarray(mask)
        identity_idx = np.flatnonzero(mask > 0)
        transform_idx = np.flatnonzero(mask <= 0)
        self.dim = mask.size
        self.n_tr = len(transform_idx)
        self.register_buffer("identity_idx", torch.as_tensor(identity_idx, dtype=torch.long))
        self.register_buffer("transform_idx", torch.as_tensor(transform_idx, dtype=torch.long))
        # column order of cat([x_id, x_tr]) back to the input order
        self.register_buffer(
            "scatter_idx",
            torch.as_tensor(
                np.argsort(np.concatenate([identity_idx, transform_idx])),
                dtype=torch.long,
            ),
        )
        n_out = self.n_tr * n_out_per_dim
        n_id = len(identity_idx)
        if net == "mlp":
            self.net = MLP(n_id, n_out, n_neurons, n_layers, activation, generator)
        elif net == "resnet":
            self.net = ResNet(n_id, n_out, n_neurons, n_layers, activation, generator)
        else:
            raise ValueError(f"Unknown net: {net}")

    def _transform_half(self, x_tr, out, inverse: bool):
        """``(y_tr, row log-determinant)`` from the conditioner output."""
        raise NotImplementedError

    def _transform(self, x, inverse: bool):
        x_id = x[:, self.identity_idx]
        y_tr, log_det = self._transform_half(x[:, self.transform_idx], self.net(x_id), inverse)
        return torch.cat([x_id, y_tr], dim=1)[:, self.scatter_idx], log_det

    def forward(self, x):
        return self._transform(x, inverse=False)

    def inverse(self, z):
        return self._transform(z, inverse=True)


class AffineCoupling(_Coupling):
    """Affine (or additive) coupling layer (RealNVP, arXiv:1605.08803).

    The identity half conditions a net giving ``(raw log-scale, shift)``
    for the transform half. The split of the columns, the soft-clamp, the
    affine map, the scatter back and the row log-determinant are one call
    of the fused layer kernel
    (:func:`~nessai_tpu_torch.ops.coupling.affine_coupling_layer`), one
    launch forward and one backward on the GPU. The volume-preserving
    (additive) coupling keeps the split of :class:`_Coupling`.
    """

    def __init__(
        self,
        mask,
        n_neurons: int,
        n_layers: int = 2,
        net: str = "resnet",
        activation: str = "relu",
        volume_preserving: bool = False,
        scale_limit: float = 5.0,
        generator=None,
    ):
        super().__init__(
            mask, 1 if volume_preserving else 2, n_neurons, n_layers, net, activation, generator
        )
        self.volume_preserving = volume_preserving
        self.scale_limit = float(scale_limit)
        # the transformed columns as the kernel reads them; derived from
        # transform_idx, so left out of the state dict
        self.register_buffer(
            "transform_idx32", self.transform_idx.to(torch.int32), persistent=False
        )

    def _transform(self, x, inverse: bool):
        if self.volume_preserving:
            return super()._transform(x, inverse)
        out = self.net(x[:, self.identity_idx])
        return affine_coupling_layer(x, out, self.transform_idx32, inverse, self.scale_limit)

    def _transform_half(self, x_tr, out, inverse: bool):
        # the volume-preserving coupling only
        y_tr = x_tr - out if inverse else x_tr + out
        return y_tr, torch.zeros(x_tr.shape[0], dtype=x_tr.dtype, device=x_tr.device)


class RQSCoupling(_Coupling):
    """Rational-quadratic spline coupling (neural spline flow,
    arXiv:1906.04032).

    The identity half conditions a net giving, per transformed column,
    ``K`` raw widths, ``K`` raw heights and the raw knot derivatives
    (``K - 1`` interior ones for linear tails, all ``K + 1`` for
    ``tails=None``). Its last layer starts at zero, so a new coupling is
    the identity spline. Linear tails go through the spline kernel
    (:func:`~nessai_tpu_torch.ops.rqs.rqs`); the log-derivative is
    summed over the columns.
    """

    def __init__(
        self,
        mask,
        n_neurons: int,
        n_layers: int = 2,
        num_bins: int = 8,
        tail_bound: float = 5.0,
        net: str = "resnet",
        activation: str = "relu",
        tails="linear",
        generator=None,
    ):
        if tails not in ("linear", None):
            raise ValueError(f"Unknown tails: {tails}")
        self.num_bins = int(num_bins)
        n_deriv = self.num_bins - 1 if tails == "linear" else self.num_bins + 1
        super().__init__(
            mask, 2 * self.num_bins + n_deriv, n_neurons, n_layers, net, activation, generator
        )
        self.tail_bound = float(tail_bound)
        self.tails = tails

    def _transform_half(self, x_tr, out, inverse: bool):
        # imported here: ops.rqs imports flows.rqs, whose package imports
        # this module
        from ..ops.rqs import on_card, rqs

        K = self.num_bins
        out = out.reshape(x_tr.shape[0], self.n_tr, -1)
        w, h, d = out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]
        if self.tails == "linear":
            y_tr, log_det = rqs(x_tr, w, h, d, inverse, self.tail_bound)
        elif on_card(x_tr):
            raise NotImplementedError(
                "RQSCoupling: tails=None has no GPU kernel yet; it comes with the "
                "unit-hypercube flows of the importance nested sampler (ROADMAP §1 item 3g)"
            )
        else:
            y_tr, log_det = rational_quadratic_spline(
                x_tr, w, h, d, inverse=inverse, tail_bound=self.tail_bound, tails=None
            )
        return y_tr, torch.sum(log_det, dim=-1)


class ActNorm(nn.Module):
    """Per-dimension affine normalisation with a data-dependent
    initialisation (Glow-style): ``z = (x + shift) * exp(log_scale)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.log_scale = nn.Parameter(torch.zeros(dim))
        self.shift = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        z = (x + self.shift) * torch.exp(self.log_scale)
        return z, torch.sum(self.log_scale) * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def inverse(self, z):
        x = z * torch.exp(-self.log_scale) - self.shift
        return x, -torch.sum(self.log_scale) * torch.ones(z.shape[0], dtype=z.dtype, device=z.device)

    @torch.no_grad()
    def data_init(self, x) -> None:
        """Whiten ``x``: zero mean and unit (population) variance, as
        ``nessai_tpu/flowmodel/base.py:_maybe_init_actnorm`` does."""
        mean = torch.mean(x, dim=0)
        std = torch.std(x, dim=0, correction=0) + 1e-6
        self.log_scale.copy_(-torch.log(std))
        self.shift.copy_(-mean)
