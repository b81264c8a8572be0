"""Masked autoregressive flow builder (arXiv:1705.07057). Counterpart of
``nessai_tpu/flows/maf.py:12-37``: ``n_blocks`` masked affine
autoregressive transforms with a permutation between consecutive ones
(and ActNorm after each where asked)."""

from .bijectors import ActNorm, Chain, MaskedAffineAutoregressive, Permutation

__all__ = ["build_maf_bijector"]


def build_maf_bijector(
    dim: int,
    n_blocks: int = 4,
    n_neurons: int = 8,
    n_layers: int = 2,
    activation: str = "relu",
    batch_norm_between_layers: bool = False,
    dropout_probability: float = 0.0,
    generator=None,
    **kwargs,
):
    """The MAF chain; the coupling builders' keys (``linear_transform``,
    ``pre_transform``, ``net``, ``context_features``, ...) are accepted
    and ignored, as in the JAX package: its nets take no context."""
    bijectors = []
    for i in range(n_blocks):
        if i > 0:
            bijectors.append(Permutation(dim, generator=generator))
        bijectors.append(
            MaskedAffineAutoregressive(
                dim,
                n_neurons=n_neurons,
                n_layers=n_layers,
                activation=activation,
                dropout_probability=dropout_probability,
                generator=generator,
            )
        )
        if batch_norm_between_layers:
            bijectors.append(ActNorm(dim))
    return Chain(bijectors)
