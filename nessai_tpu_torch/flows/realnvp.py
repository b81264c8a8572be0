"""RealNVP builder. Counterpart of ``nessai_tpu/flows/realnvp.py``:
``n_blocks`` × [Permutation → AffineCoupling → ActNorm]."""

import numpy as np

from .bijectors import ActNorm, AffineCoupling, Chain, Permutation

__all__ = ["build_realnvp_bijector", "alternating_masks"]


def alternating_masks(dim: int, n_blocks: int):
    base = np.arange(dim) % 2
    return [base if i % 2 == 0 else 1 - base for i in range(n_blocks)]


def build_realnvp_bijector(
    dim: int,
    n_blocks: int = 4,
    n_neurons: int = 8,
    n_layers: int = 2,
    mask=None,
    net: str = "resnet",
    activation: str = "relu",
    volume_preserving: bool = False,
    generator=None,
):
    if mask is None:
        masks = alternating_masks(dim, n_blocks)
    else:
        mask = np.asarray(mask)
        if mask.ndim == 1:
            masks = [mask if i % 2 == 0 else 1 - mask for i in range(n_blocks)]
        else:
            if len(mask) != n_blocks:
                raise ValueError("Mask does not match number of blocks")
            masks = list(mask)
    bijectors = []
    for i in range(n_blocks):
        bijectors.append(Permutation(dim, generator=generator))
        bijectors.append(
            AffineCoupling(
                masks[i],
                n_neurons=n_neurons,
                n_layers=n_layers,
                net=net,
                activation=activation,
                volume_preserving=volume_preserving,
                generator=generator,
            )
        )
        bijectors.append(ActNorm(dim))
    return Chain(bijectors)
