"""A plain RealNVP, built from a trained flow's weights.

Written from the published description (Dinh et al., arXiv:1605.08803)
and the layer order the benchmark's configurations state: each block is
a fixed permutation of the columns, an affine coupling whose conditioner
is a pre-activation residual net (ReLU), and an ActNorm. The coupling
soft-clamps the raw log-scale, ``s = c tanh(raw / c)`` with ``c =
SCALE_CLAMP``, and maps the transformed half as ``y = x e^s + t``. The base
is the unit Gaussian.

The structure is read from the names of the state dict's entries alone
(``...perm``, ``...net.initial.weight``, ``...log_scale``), so nothing of
the program is imported. Every operation is a plain ``torch`` call in the
dtype the caller asks for: float64 for the reference, float32 with TF32
matmuls for the control.
"""

import math
import re

import numpy as np
import torch

__all__ = ["SCALE_CLAMP", "PlainRealNVP"]

#: the soft clamp of the coupling's log-scale
SCALE_CLAMP = 5.0

_LAYER = re.compile(r"^bijector\.bijectors\.(\d+)\.(.+)$")


class PlainRealNVP:
    """``log_prob(x)`` and ``inverse(z)`` of a RealNVP whose weights are
    ``state`` (a mapping of names to arrays), in ``dtype`` on ``device``.

    The weights sit in :attr:`tensors` under their names in ``state``;
    :meth:`log_prob_t` and :meth:`inverse_t` take tensors and another
    such mapping of weights, so that gradients can be taken through them
    (the replay of training steps, :mod:`.adamw`)."""

    def __init__(self, state, dtype=torch.float64, device="cpu"):
        self.dtype = dtype
        self.device = torch.device(device)
        layers = {}
        for key, value in state.items():
            m = _LAYER.match(key)
            if m is None:
                continue
            arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = (key, arr)
        self.tensors = {}
        self.layers = []
        for i in sorted(layers):
            p = layers[i]
            if "perm" in p:
                perm = torch.as_tensor(p["perm"][1].astype(np.int64), device=self.device)
                self.layers.append(("perm", perm, torch.argsort(perm)))
            elif "net.initial.weight" in p:
                self.layers.append(("coupling", self._coupling(p)))
            elif "log_scale" in p:
                self.layers.append(("actnorm", self._t(*p["log_scale"]), self._t(*p["shift"])))
            else:
                raise ValueError(f"layer {i} is of no kind this reference knows: {sorted(p)}")
        if not self.layers:
            raise ValueError("no layers in the state dict")

    def _t(self, key, a):
        self.tensors[key] = torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)
        return key

    def _coupling(self, p):
        n_blocks = len({k.split(".")[2] for k in p if k.startswith("net.blocks.")})
        blocks = [
            tuple(self._t(*p[f"net.blocks.{j}.{name}"]) for name in ("l1.weight", "l1.bias", "l2.weight", "l2.bias"))
            for j in range(n_blocks)
        ]
        return dict(
            identity=torch.as_tensor(p["identity_idx"][1].astype(np.int64), device=self.device),
            transform=torch.as_tensor(p["transform_idx"][1].astype(np.int64), device=self.device),
            initial=(self._t(*p["net.initial.weight"]), self._t(*p["net.initial.bias"])),
            blocks=blocks,
            final=(self._t(*p["net.final.weight"]), self._t(*p["net.final.bias"])),
        )

    @staticmethod
    def _net(c, w, x):
        relu = torch.relu
        h = x @ w[c["initial"][0]].T + w[c["initial"][1]]
        for w1, b1, w2, b2 in c["blocks"]:
            h = h + (relu(relu(h) @ w[w1].T + w[b1]) @ w[w2].T + w[b2])
        return relu(h) @ w[c["final"][0]].T + w[c["final"][1]]

    def _couple(self, c, w, x, inverse):
        n_tr = c["transform"].numel()
        out = self._net(c, w, x[:, c["identity"]])
        s = SCALE_CLAMP * torch.tanh(out[:, :n_tr] / SCALE_CLAMP)
        shift = out[:, n_tr:]
        x_tr = x[:, c["transform"]]
        y_tr = (x_tr - shift) * torch.exp(-s) if inverse else x_tr * torch.exp(s) + shift
        y = x.clone()
        y[:, c["transform"]] = y_tr
        return y, (-1.0 if inverse else 1.0) * torch.sum(s, dim=1)

    def _in(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    def forward_t(self, x, w=None):
        """x -> (z, log|dz/dx|), tensors in the weights ``w`` (by default
        :attr:`tensors`)."""
        w = self.tensors if w is None else w
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for layer in self.layers:
            if layer[0] == "perm":
                x = x[:, layer[1]]
            elif layer[0] == "coupling":
                x, ld = self._couple(layer[1], w, x, inverse=False)
                log_det = log_det + ld
            else:
                log_scale, shift = w[layer[1]], w[layer[2]]
                x = (x + shift) * torch.exp(log_scale)
                log_det = log_det + torch.sum(log_scale)
        return x, log_det

    def inverse_t(self, z, w=None):
        """z -> (x, log|dx/dz|), tensors in the weights ``w``."""
        w = self.tensors if w is None else w
        x = z
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for layer in reversed(self.layers):
            if layer[0] == "perm":
                x = x[:, layer[2]]
            elif layer[0] == "coupling":
                x, ld = self._couple(layer[1], w, x, inverse=True)
                log_det = log_det + ld
            else:
                log_scale, shift = w[layer[1]], w[layer[2]]
                x = x * torch.exp(-log_scale) - shift
                log_det = log_det - torch.sum(log_scale)
        return x, log_det

    def log_prob_t(self, x, w=None):
        """log q(x) under the unit-Gaussian base, a tensor."""
        z, log_det = self.forward_t(x, w)
        return -0.5 * torch.sum(z**2, dim=1) - 0.5 * z.shape[1] * math.log(2 * math.pi) + log_det

    @torch.no_grad()
    def forward(self, x):
        """x -> (z, log|dz/dx|) as float64 numpy."""
        z, log_det = self.forward_t(self._in(x))
        return z.double().cpu().numpy(), log_det.double().cpu().numpy()

    @torch.no_grad()
    def inverse(self, z):
        """z -> (x, log|dx/dz|) as float64 numpy."""
        x, log_det = self.inverse_t(self._in(z))
        return x.double().cpu().numpy(), log_det.double().cpu().numpy()

    @torch.no_grad()
    def log_prob(self, x):
        """log q(x) under the unit-Gaussian base, as float64 numpy."""
        return self.log_prob_t(self._in(x)).double().cpu().numpy()
