"""RealNVP builder. Counterpart of ``nessai_tpu/flows/realnvp.py``:
(Logit →) ``n_blocks`` × [linear transform → AffineCoupling → ActNorm],
each coupling's net conditioned on a context of ``context_features``
columns where that is set."""

import numpy as np

from .bijectors import ActNorm, AffineCoupling, Chain, Logit, LULinear, Permutation, SVDLinear

__all__ = [
    "build_realnvp_bijector",
    "alternating_masks",
    "block_masks",
    "make_linear_transform",
    "make_pre_transform",
]


def alternating_masks(dim: int, n_blocks: int):
    base = np.arange(dim) % 2
    return [base if i % 2 == 0 else 1 - base for i in range(n_blocks)]


def block_masks(dim: int, n_blocks: int, mask=None):
    """One coupling mask per block: alternating by default, a 1-D mask
    and its complement in turn, or one mask per block."""
    if mask is None:
        return alternating_masks(dim, n_blocks)
    mask = np.asarray(mask)
    if mask.ndim == 1:
        return [mask if i % 2 == 0 else 1 - mask for i in range(n_blocks)]
    if len(mask) != n_blocks:
        raise ValueError("Mask does not match number of blocks")
    return list(mask)


def make_linear_transform(kind, dim: int, generator=None):
    """The linear transform between coupling blocks
    (``nessai_tpu/flows/realnvp.py:36-56``): a random permutation, a
    permutation and an LU- or SVD-parameterised linear layer, or nothing
    for ``None``/``"none"``."""
    if kind is None or kind == "none":
        return []
    if kind == "permutation":
        return [Permutation(dim, generator=generator)]
    if kind == "lu":
        return [Permutation(dim, generator=generator), LULinear(dim, generator=generator)]
    if kind == "svd":
        return [Permutation(dim, generator=generator), SVDLinear(dim, generator=generator)]
    raise ValueError(f"Unknown linear transform: {kind}")


def make_pre_transform(pre_transform):
    """The bijectors before the first block: a :class:`Logit` for
    ``"logit"`` (``nessai_tpu/flows/realnvp.py:81``), none for None."""
    if pre_transform == "logit":
        return [Logit()]
    if pre_transform is not None:
        raise ValueError(f"Unknown pre-transform: {pre_transform}")
    return []


def build_realnvp_bijector(
    dim: int,
    n_blocks: int = 4,
    n_neurons: int = 8,
    n_layers: int = 2,
    mask=None,
    net: str = "resnet",
    activation: str = "relu",
    linear_transform="permutation",
    batch_norm_between_layers: bool = True,
    volume_preserving: bool = False,
    pre_transform=None,
    dropout_probability: float = 0.0,
    context_features=None,
    generator=None,
    **kwargs,
):
    """The RealNVP chain; keys of other builders (``tails``, ``num_bins``,
    ...) are accepted and ignored, as in the JAX package."""
    bijectors = make_pre_transform(pre_transform)
    for m in block_masks(dim, n_blocks, mask):
        bijectors += make_linear_transform(linear_transform, dim, generator)
        bijectors.append(
            AffineCoupling(
                m,
                n_neurons=n_neurons,
                n_layers=n_layers,
                net=net,
                activation=activation,
                volume_preserving=volume_preserving,
                dropout_probability=dropout_probability,
                context_features=context_features,
                generator=generator,
            )
        )
        if batch_norm_between_layers:
            bijectors.append(ActNorm(dim))
    return Chain(bijectors)
