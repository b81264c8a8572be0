"""Conditioner networks (MLP and residual net) as ``nn.Module``s.
Counterpart of ``nessai_tpu/flows/nets.py``.

Dense layers are ``nn.Linear`` (weight ``[out, in]``; the JAX package
stores ``w`` as ``[in, out]``, see ``convert.py``). Hidden layers start
uniform in ±1/sqrt(n_in) with zero biases, as in the JAX package; the
final layer starts at zero so every coupling starts as the identity.
A ``dropout_probability`` above 0 adds inverted dropout where the JAX
package's ``apply_mlp``/``apply_resnet`` drop (``nets.py:55-62,
113-131``); it is active only in training mode (``module.train()``),
which the flow model sets for its optimiser steps alone.

A conditional net (``context_features`` in a coupling) has a first layer
of ``n_in + context_features`` inputs and is called as ``net(x,
context)``: its input is ``cat([x, context])``, as the JAX package's
``apply_mlp``/``apply_resnet`` build it (``nets.py:74, 119``). Without a
context the input is ``x`` alone.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["ACTIVATIONS", "MLP", "ResNet", "make_dropout"]

ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
}


def _dense(n_in: int, n_out: int, generator=None, zero: bool = False) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        if zero:
            layer.weight.zero_()
        else:
            bound = 1.0 / math.sqrt(max(n_in, 1))
            layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.zero_()
    return layer


def make_dropout(p: float):
    """An ``nn.Dropout`` for ``p > 0``, else None (no module, so a net
    without dropout runs as before)."""
    return nn.Dropout(float(p)) if p and p > 0.0 else None


class MLP(nn.Module):
    """``n_layers`` hidden layers of width ``n_neurons``, dropout after
    each hidden activation."""

    def __init__(
        self, n_in, n_out, n_neurons, n_layers, activation="relu", generator=None, dropout_probability=0.0
    ):
        super().__init__()
        self.activation = activation
        dims = [n_in] + [n_neurons] * n_layers
        self.layers = nn.ModuleList(
            _dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.out = _dense(dims[-1], n_out, zero=True)
        self.dropout = make_dropout(dropout_probability)

    def forward(self, x, context=None):
        act = ACTIVATIONS[self.activation]
        if context is not None:
            x = torch.cat([x, context], dim=-1)
        for layer in self.layers:
            x = act(layer(x))
            if self.dropout is not None:
                x = self.dropout(x)
        return self.out(x)


class ResBlock(nn.Module):
    def __init__(self, n_neurons, generator=None):
        super().__init__()
        self.l1 = _dense(n_neurons, n_neurons, generator)
        self.l2 = _dense(n_neurons, n_neurons, generator)


class ResNet(nn.Module):
    """Pre-activation residual net: an input layer, ``n_blocks`` blocks of
    two dense layers (dropout between them), and a zero-initialised
    output layer."""

    def __init__(
        self, n_in, n_out, n_neurons, n_blocks=2, activation="relu", generator=None, dropout_probability=0.0
    ):
        super().__init__()
        self.activation = activation
        self.initial = _dense(n_in, n_neurons, generator)
        self.blocks = nn.ModuleList(
            ResBlock(n_neurons, generator) for _ in range(n_blocks)
        )
        self.final = _dense(n_neurons, n_out, zero=True)
        self.dropout = make_dropout(dropout_probability)

    def forward(self, x, context=None):
        act = ACTIVATIONS[self.activation]
        if context is not None:
            x = torch.cat([x, context], dim=-1)
        h = self.initial(x)
        for block in self.blocks:
            t = act(block.l1(act(h)))
            if self.dropout is not None:
                t = self.dropout(t)
            h = h + block.l2(t)
        return self.final(act(h))
