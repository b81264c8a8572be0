"""Bijectors as ``nn.Module``s. Counterpart of
``nessai_tpu/flows/bijectors.py``: ``Chain``, ``Permutation``,
``AffineCoupling``, ``RQSCoupling``, ``ActNorm``, the linear layers
``LULinear`` and ``SVDLinear``, the ``Logit`` pre-transform and the
masked autoregressive ``MaskedAffineAutoregressive``.

``forward(x, context=None)`` maps data to latent and ``inverse(z,
context=None)`` latent to data; both return ``(output, log_det)`` with
``log_det`` the per-row log of the Jacobian determinant of the applied
direction. The context (``[n, context_features]``) reaches the couplings'
conditioner nets, which then take ``[x_id, context]``; every other
bijector takes it and ignores it, as in the JAX package
(``nessai_tpu/flows/bijectors.py:77-343``).
"""

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.coupling import affine_coupling_layer
from .nets import ACTIVATIONS, MLP, ResNet, make_dropout
from .rqs import n_derivatives

__all__ = [
    "Bijector",
    "Chain",
    "Permutation",
    "AffineCoupling",
    "RQSCoupling",
    "ActNorm",
    "LULinear",
    "SVDLinear",
    "Logit",
    "MaskedAffineAutoregressive",
]


class Bijector(nn.Module):
    """The base of the bijectors: ``forward(x, context=None)`` and
    ``inverse(z, context=None)``, each returning ``(output, per-row
    log|det J|)`` of its direction. The parameters live on the module
    (the JAX package's ``Bijector`` keeps them apart, in a tree that its
    ``init(key)`` makes)."""

    def forward(self, x, context=None):
        raise NotImplementedError

    def inverse(self, z, context=None):
        raise NotImplementedError


class Chain(Bijector):
    """Composition; ``forward`` applies the bijectors in order."""

    def __init__(self, bijectors):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)

    def forward(self, x, context=None):
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for b in self.bijectors:
            x, ld = b(x, context)
            log_det = log_det + ld
        return x, log_det

    def inverse(self, z, context=None):
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for b in reversed(self.bijectors):
            z, ld = b.inverse(z, context)
            log_det = log_det + ld
        return z, log_det


class Permutation(Bijector):
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

    def forward(self, x, context=None):
        return x[:, self.perm], torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def inverse(self, z, context=None):
        return z[:, self.inv], torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


class _Coupling(Bijector):
    """The split of a coupling layer: the identity half (``mask > 0``)
    feeds a conditioner net with ``n_out`` outputs, which parameterise
    the transform of the other half. With ``context_features`` the net
    takes ``[x_id, context]``."""

    def __init__(
        self,
        mask,
        n_out_per_dim,
        n_neurons,
        n_layers,
        net,
        activation,
        generator,
        dropout_probability=0.0,
        context_features=None,
    ):
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
        n_id = len(identity_idx) + (context_features or 0)
        if net == "mlp":
            self.net = MLP(n_id, n_out, n_neurons, n_layers, activation, generator, dropout_probability)
        elif net == "resnet":
            self.net = ResNet(n_id, n_out, n_neurons, n_layers, activation, generator, dropout_probability)
        else:
            raise ValueError(f"Unknown net: {net}")

    def _transform_half(self, x_tr, out, inverse: bool):
        """``(y_tr, row log-determinant)`` from the conditioner output."""
        raise NotImplementedError

    def _transform(self, x, inverse: bool, context=None):
        x_id = x[:, self.identity_idx]
        y_tr, log_det = self._transform_half(x[:, self.transform_idx], self.net(x_id, context), inverse)
        return torch.cat([x_id, y_tr], dim=1)[:, self.scatter_idx], log_det

    def forward(self, x, context=None):
        return self._transform(x, inverse=False, context=context)

    def inverse(self, z, context=None):
        return self._transform(z, inverse=True, context=context)


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
        dropout_probability: float = 0.0,
        context_features=None,
        generator=None,
    ):
        super().__init__(
            mask,
            1 if volume_preserving else 2,
            n_neurons,
            n_layers,
            net,
            activation,
            generator,
            dropout_probability,
            context_features,
        )
        self.volume_preserving = volume_preserving
        self.scale_limit = float(scale_limit)
        # the transformed columns as the kernel reads them; derived from
        # transform_idx, so left out of the state dict
        self.register_buffer(
            "transform_idx32", self.transform_idx.to(torch.int32), persistent=False
        )

    def _transform(self, x, inverse: bool, context=None):
        if self.volume_preserving:
            return super()._transform(x, inverse, context)
        out = self.net(x[:, self.identity_idx], context)
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
    the identity spline. Both go through the spline kernel
    (:func:`~nessai_tpu_torch.ops.rqs.rqs`): linear tails on
    ``[-tail_bound, tail_bound]``, or ``tails=None`` on the unit box; the
    log-derivative is summed over the columns.
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
        dropout_probability: float = 0.0,
        context_features=None,
        generator=None,
    ):
        self.num_bins = int(num_bins)
        super().__init__(
            mask,
            2 * self.num_bins + n_derivatives(self.num_bins, tails),
            n_neurons,
            n_layers,
            net,
            activation,
            generator,
            dropout_probability,
            context_features,
        )
        self.tail_bound = float(tail_bound)
        self.tails = tails

    def _transform_half(self, x_tr, out, inverse: bool):
        # imported here: ops.rqs imports flows.rqs, whose package imports
        # this module
        from ..ops.rqs import rqs

        K = self.num_bins
        out = out.reshape(x_tr.shape[0], self.n_tr, -1)
        w, h, d = out[..., :K], out[..., K : 2 * K], out[..., 2 * K :]
        y_tr, log_det = rqs(x_tr, w, h, d, inverse, self.tail_bound, self.tails)
        return y_tr, torch.sum(log_det, dim=-1)


class ActNorm(Bijector):
    """Per-dimension affine normalisation with a data-dependent
    initialisation (Glow-style): ``z = (x + shift) * exp(log_scale)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.log_scale = nn.Parameter(torch.zeros(dim))
        self.shift = nn.Parameter(torch.zeros(dim))

    def forward(self, x, context=None):
        z = (x + self.shift) * torch.exp(self.log_scale)
        return z, torch.sum(self.log_scale) * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def inverse(self, z, context=None):
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


def _row_constant(value, x):
    """``value`` (a 0-d tensor) repeated for every row of ``x``."""
    return value * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


class LULinear(Bijector):
    """Invertible linear layer ``z = x W^T + b`` with ``W = L U``: ``L``
    unit lower triangular, ``U`` upper triangular with diagonal
    ``exp(log_diag)`` (``nessai_tpu/flows/bijectors.py:346-404``; the
    permutation of its ``P L U`` is the :class:`Permutation` before it).
    The forward is a matrix product, the inverse two triangular solves,
    the log-determinant ``sum(log_diag)``. Starts at the identity unless
    ``identity_init`` is False (then 1e-3 N(0, 1) entries)."""

    def __init__(self, dim: int, identity_init: bool = True, generator=None):
        super().__init__()
        self.dim = dim
        if identity_init:
            lower, upper, log_diag = torch.zeros(dim, dim), torch.zeros(dim, dim), torch.zeros(dim)
        else:
            lower = 1e-3 * torch.randn(dim, dim, generator=generator)
            upper = 1e-3 * torch.randn(dim, dim, generator=generator)
            log_diag = 1e-3 * torch.randn(dim, generator=generator)
        self.lower = nn.Parameter(lower)
        self.upper = nn.Parameter(upper)
        self.log_diag = nn.Parameter(log_diag)
        self.bias = nn.Parameter(torch.zeros(dim))

    def _lu(self):
        eye = torch.eye(self.dim, dtype=self.lower.dtype, device=self.lower.device)
        L = torch.tril(self.lower, -1) + eye
        U = torch.triu(self.upper, 1) + torch.diag(torch.exp(self.log_diag))
        return L, U

    def forward(self, x, context=None):
        L, U = self._lu()
        z = x @ (L @ U).T + self.bias
        return z, _row_constant(torch.sum(self.log_diag), x)

    def inverse(self, z, context=None):
        L, U = self._lu()
        # W x^T = (z - b)^T, by two triangular solves
        t = torch.linalg.solve_triangular(L, (z - self.bias).T, upper=False)
        x = torch.linalg.solve_triangular(U, t, upper=True).T
        return x, _row_constant(-torch.sum(self.log_diag), z)


class SVDLinear(Bijector):
    """Invertible linear layer ``z = x W^T + b`` with ``W = U diag(exp(
    log_s)) V^T``, ``U`` and ``V`` products of ``num_householder``
    Householder reflections (``nessai_tpu/flows/bijectors.py:406-485``).
    The inverse is exact and solve-free, ``W^-1 = V diag(exp(-log_s))
    U^T``; the log-determinant is ``sum(log_s)``."""

    def __init__(self, dim: int, num_householder=None, identity_init: bool = True, generator=None):
        super().__init__()
        self.dim = dim
        # an even count keeps det(U) = det(V) = +1
        self.num_householder = int(num_householder or max(2, dim - dim % 2))
        self.vs_u = nn.Parameter(torch.randn(self.num_householder, dim, generator=generator))
        self.vs_v = nn.Parameter(torch.randn(self.num_householder, dim, generator=generator))
        log_s = torch.zeros(dim) if identity_init else 1e-3 * torch.randn(dim, generator=generator)
        self.log_s = nn.Parameter(log_s)
        self.bias = nn.Parameter(torch.zeros(dim))

    @staticmethod
    def _householder_product(vs):
        """``H(v_1) ... H(v_k)`` with ``H(v) = I - 2 v v^T / (v.v)``."""
        q = torch.eye(vs.shape[-1], dtype=vs.dtype, device=vs.device)
        for v in vs:
            coeff = 2.0 / torch.clamp_min(torch.dot(v, v), 1e-12)
            q = q - coeff * torch.outer(v, v @ q)
        return q

    def forward(self, x, context=None):
        u = self._householder_product(self.vs_u)
        v = self._householder_product(self.vs_v)
        z = ((x @ v) * torch.exp(self.log_s)) @ u.T + self.bias
        return z, _row_constant(torch.sum(self.log_s), x)

    def inverse(self, z, context=None):
        u = self._householder_product(self.vs_u)
        v = self._householder_product(self.vs_v)
        x = (((z - self.bias) @ u) * torch.exp(-self.log_s)) @ v.T
        return x, _row_constant(-torch.sum(self.log_s), z)


class Logit(Bijector):
    """Forward the logit of ``[0, 1]`` (inputs clipped to ``[eps, 1 -
    eps]``), inverse the sigmoid (``nessai_tpu/flows/bijectors.py:
    545-562``): the pre-transform of flows on unit-interval data."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, x, context=None):
        x = torch.clamp(x, self.eps, 1 - self.eps)
        z = torch.log(x) - torch.log1p(-x)
        return z, torch.sum(-torch.log(x) - torch.log1p(-x), dim=-1)

    def inverse(self, z, context=None):
        x = torch.sigmoid(z)
        return x, torch.sum(torch.log(x) + torch.log1p(-x), dim=-1)


def made_masks(dim: int, n_neurons: int, n_layers: int):
    """The MADE masks ``[n_in, n_out]`` of each layer, built as
    ``nessai_tpu/flows/bijectors.py:593-609`` builds them: input degrees
    1..dim, hidden degrees cycling through 1..dim-1, and each output (log
    scale, then shift) of dimension i seeing the inputs before it."""
    degrees_in = np.arange(1, dim + 1)
    masks = []
    prev = degrees_in
    for _ in range(n_layers):
        hidden = (np.arange(n_neurons) % max(dim - 1, 1)) + 1
        masks.append((hidden[None, :] >= prev[:, None]).astype(np.float32))
        prev = hidden
    out_degrees = np.tile(degrees_in, 2)
    masks.append((out_degrees[None, :] > prev[:, None]).astype(np.float32))
    return masks


class MaskedAffineAutoregressive(Bijector):
    """Masked affine autoregressive transform (MAF, arXiv:1705.07057; a
    MADE conditioner; ``nessai_tpu/flows/bijectors.py:564-657``).

    ``z = x exp(s) + t`` with ``s = c tanh(raw_s / c)`` and ``(raw_s,
    t)`` the masked net of ``x``: one parallel pass forward; the inverse
    is a loop over the dimensions, dimension i from the net of the
    dimensions before it. Dropout (``dropout_probability``) follows each
    hidden activation, in training mode only."""

    def __init__(
        self,
        dim: int,
        n_neurons: int,
        n_layers: int = 2,
        activation: str = "relu",
        scale_limit: float = 5.0,
        dropout_probability: float = 0.0,
        generator=None,
    ):
        super().__init__()
        self.dim = dim
        self.activation = activation
        self.scale_limit = float(scale_limit)
        masks = made_masks(dim, n_neurons, n_layers)
        self.layers = nn.ModuleList()
        for i, m in enumerate(masks):
            n_in, n_out = m.shape
            layer = nn.Linear(n_in, n_out)
            with torch.no_grad():
                if i == len(masks) - 1:
                    layer.weight.zero_()
                else:
                    bound = 1.0 / math.sqrt(max(n_in, 1))
                    layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.zero_()
            self.layers.append(layer)
            # [n_out, n_in], as nn.Linear keeps its weight; fixed by the
            # configuration, so left out of the state dict
            self.register_buffer(f"mask_{i}", torch.as_tensor(m.T.copy()), persistent=False)
        self.dropout = make_dropout(dropout_probability)

    def _net(self, x):
        act = ACTIVATIONS[self.activation]
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = F.linear(h, layer.weight * getattr(self, f"mask_{i}"), layer.bias)
            if i < last:
                h = act(h)
                if self.dropout is not None:
                    h = self.dropout(h)
        raw_s, t = h[..., : self.dim], h[..., self.dim :]
        s = self.scale_limit * torch.tanh(raw_s / self.scale_limit)
        return s, t

    def forward(self, x, context=None):
        s, t = self._net(x)
        return x * torch.exp(s) + t, torch.sum(s, dim=-1)

    def inverse(self, z, context=None):
        x = torch.zeros_like(z)
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for i in range(self.dim):
            s, t = self._net(x)
            x_i = (z[:, i] - t[:, i]) * torch.exp(-s[:, i])
            x = torch.cat([x[:, :i], x_i[:, None], x[:, i + 1 :]], dim=1)
            log_det = log_det - s[:, i]
        return x, log_det
