"""Neural spline flow builder (arXiv:1906.04032). Counterpart of
``nessai_tpu/flows/nsf.py``: (Logit →) ``n_blocks`` × [linear transform →
RQSCoupling (→ ActNorm)], with 8 bins and linear tails on [-5, 5] by
default, each coupling's net conditioned on a context of
``context_features`` columns where that is set."""

from .bijectors import ActNorm, Chain, RQSCoupling
from .realnvp import block_masks, make_linear_transform, make_pre_transform

__all__ = ["build_nsf_bijector"]


def build_nsf_bijector(
    dim: int,
    n_blocks: int = 4,
    n_neurons: int = 8,
    n_layers: int = 2,
    num_bins: int = 8,
    tail_bound: float = 5.0,
    tails="linear",
    mask=None,
    net: str = "resnet",
    activation: str = "relu",
    linear_transform="permutation",
    batch_norm_between_layers: bool = False,
    pre_transform=None,
    dropout_probability: float = 0.0,
    context_features=None,
    generator=None,
    **kwargs,
):
    """The neural-spline chain; keys of other builders are accepted and
    ignored, as in the JAX package."""
    bijectors = make_pre_transform(pre_transform)
    for m in block_masks(dim, n_blocks, mask):
        bijectors += make_linear_transform(linear_transform, dim, generator)
        bijectors.append(
            RQSCoupling(
                m,
                n_neurons=n_neurons,
                n_layers=n_layers,
                num_bins=num_bins,
                tail_bound=tail_bound,
                tails=tails,
                net=net,
                activation=activation,
                dropout_probability=dropout_probability,
                context_features=context_features,
                generator=generator,
            )
        )
        if batch_norm_between_layers:
            bijectors.append(ActNorm(dim))
    return Chain(bijectors)
