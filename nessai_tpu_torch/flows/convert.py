"""Weight conversion between the JAX package's flow parameters and the
port's modules.

The JAX package keeps a flow's parameters as a pytree
``{"bijector": [per-bijector dict, ...], "base": {}}``; here it is given
and returned as numpy arrays. A dense layer is ``{"w": [n_in, n_out],
"b": [n_out]}`` there and ``nn.Linear`` (weight ``[n_out, n_in]``) here,
so weights are transposed. A conditional net's first layer takes
``[x_id, context]`` in both packages, so its wider weight maps column for
column. Permutations become buffers. A coupling
(affine or spline, either tails) is ``{"net": ...}``; a chain without
ActNorm simply has no such entries. ``LULinear`` is ``{"lower", "upper",
"log_diag", "bias"}``, ``SVDLinear`` ``{"vs_u", "vs_v", "log_s",
"bias"}``, ``MaskedAffineAutoregressive`` ``{"layers": [dense, ...]}``
(the unmasked weights) and ``Logit`` ``{}``. The base distribution is
``{}`` but for LARS, ``{"net": MLP, "log_Z": scalar}``. :func:`levels_from_jax` carries the per-level
parameters of the JAX package's ``ImportanceFlowModel`` into the port's.
:func:`state_dict_from_jax_file` and :func:`level_state_dicts_from_jax`
read the JAX package's weight files (a pickled pytree of numpy arrays:
``FlowModel.save_weights``' ``model.pkl``, and the importance nested
sampler's ``level_<i>/model.pkl``) into the port's ``state_dict``s.
"""

import copy
import os
import pickle

import numpy as np
import torch

from .bijectors import (
    ActNorm,
    AffineCoupling,
    Logit,
    LULinear,
    MaskedAffineAutoregressive,
    Permutation,
    RQSCoupling,
    SVDLinear,
)
from .distributions import ResampledGaussian
from .nets import MLP, ResNet

__all__ = [
    "params_from_jax",
    "params_to_jax",
    "levels_from_jax",
    "state_dict_from_jax_file",
    "level_state_dicts_from_jax",
]


def _dense_from(layer, p):
    layer.weight.copy_(torch.tensor(np.asarray(p["w"], np.float32).T))
    layer.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))


def _dense_to(layer):
    return {
        "w": layer.weight.detach().cpu().numpy().T.copy(),
        "b": layer.bias.detach().cpu().numpy().copy(),
    }


def _net_from(net, p):
    if isinstance(net, ResNet):
        _dense_from(net.initial, p["initial"])
        for block, bp in zip(net.blocks, p["blocks"], strict=True):
            _dense_from(block.l1, bp["l1"])
            _dense_from(block.l2, bp["l2"])
        _dense_from(net.final, p["final"])
    elif isinstance(net, MLP):
        for layer, lp in zip(net.layers, p["layers"], strict=True):
            _dense_from(layer, lp)
        _dense_from(net.out, p["out"])
    else:
        raise TypeError(f"Unknown conditioner: {type(net).__name__}")


def _net_to(net):
    if isinstance(net, ResNet):
        return {
            "initial": _dense_to(net.initial),
            "blocks": [
                {"l1": _dense_to(b.l1), "l2": _dense_to(b.l2)} for b in net.blocks
            ],
            "final": _dense_to(net.final),
        }
    return {
        "layers": [_dense_to(layer) for layer in net.layers],
        "out": _dense_to(net.out),
    }


#: the parameters, by their JAX names, of the bijectors that are plain
#: tensors
_TENSORS = {
    ActNorm: ("log_scale", "shift"),
    LULinear: ("lower", "upper", "log_diag", "bias"),
    SVDLinear: ("vs_u", "vs_v", "log_s", "bias"),
}


def _copy_into(param, value) -> None:
    param.copy_(torch.tensor(np.asarray(value, np.float32)))


@torch.no_grad()
def params_from_jax(flow, params) -> None:
    """Load the JAX package's flow parameters (numpy pytree) into
    ``flow`` in place."""
    bijectors = flow.bijector.bijectors
    for b, p in zip(bijectors, params["bijector"], strict=True):
        if isinstance(b, Permutation):
            device = b.perm.device
            b.perm = torch.tensor(np.asarray(p["perm"]), dtype=torch.long, device=device)
            b.inv = torch.tensor(np.asarray(p["inv"]), dtype=torch.long, device=device)
        elif isinstance(b, (AffineCoupling, RQSCoupling)):
            _net_from(b.net, p["net"])
        elif type(b) in _TENSORS:
            for name in _TENSORS[type(b)]:
                _copy_into(getattr(b, name), p[name])
        elif isinstance(b, MaskedAffineAutoregressive):
            for layer, lp in zip(b.layers, p["layers"], strict=True):
                _dense_from(layer, lp)
        elif not isinstance(b, Logit):
            raise TypeError(f"Unknown bijector: {type(b).__name__}")
    if isinstance(flow.base, ResampledGaussian):
        _net_from(flow.base.net, params["base"]["net"])
        _copy_into(flow.base.log_Z, params["base"]["log_Z"])


def params_to_jax(flow) -> dict:
    """The JAX package's parameter pytree (numpy arrays) for ``flow``."""
    out = []
    for b in flow.bijector.bijectors:
        if isinstance(b, Permutation):
            out.append(
                {
                    "perm": b.perm.cpu().numpy().astype(np.int32),
                    "inv": b.inv.cpu().numpy().astype(np.int32),
                }
            )
        elif isinstance(b, (AffineCoupling, RQSCoupling)):
            out.append({"net": _net_to(b.net)})
        elif type(b) in _TENSORS:
            out.append({name: getattr(b, name).detach().cpu().numpy().copy() for name in _TENSORS[type(b)]})
        elif isinstance(b, MaskedAffineAutoregressive):
            out.append({"layers": [_dense_to(layer) for layer in b.layers]})
        elif isinstance(b, Logit):
            out.append({})
        else:
            raise TypeError(f"Unknown bijector: {type(b).__name__}")
    base = {}
    if isinstance(flow.base, ResampledGaussian):
        base = {"net": _net_to(flow.base.net), "log_Z": flow.base.log_Z.detach().cpu().numpy().copy()}
    return {"bijector": out, "base": base}


def levels_from_jax(flow_model, params_list) -> None:
    """Replace the levels of ``flow_model`` (an initialised
    :class:`~nessai_tpu_torch.flowmodel.ImportanceFlowModel`) with the
    JAX package's per-level parameter pytrees (numpy), in order; the
    flow in training takes the last level's weights."""
    flow_model.models = []
    for params in params_list:
        params_from_jax(flow_model.flow, params)
        flow_model.add_level(flow_model.flow)


def state_dict_from_jax_file(flow, weights_file) -> dict:
    """The port's ``state_dict`` (CPU tensors) for the JAX package's
    weights file ``weights_file``, on the architecture of ``flow`` (which
    is left as it is)."""
    with open(weights_file, "rb") as f:
        params = pickle.load(f)
    target = copy.deepcopy(flow).cpu()
    params_from_jax(target, params)
    return {k: v.detach().clone() for k, v in target.state_dict().items()}


def level_state_dicts_from_jax(flow, output) -> list:
    """The port's ``state_dict`` of every level that the JAX package's
    importance nested sampler saved under ``output``
    (``level_<i>/model.pkl`` for i = 0, 1, ... while the files exist)."""
    out = []
    while os.path.exists(path := os.path.join(output, f"level_{len(out)}", "model.pkl")):
        out.append(state_dict_from_jax_file(flow, path))
    return out
