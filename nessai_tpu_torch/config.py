"""Global configuration: live-point layout and numerical constants.

Counterpart of ``nessai_tpu/config.py`` without the JAX compute knobs
(the port always runs its kernels on CUDA tensors).
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

__all__ = ["livepoints", "general"]


@dataclass
class LivepointsConfig:
    """Configuration for live-point structured arrays."""

    logl_dtype: str = "f8"
    it_dtype: str = "i4"
    it_default: int = 0
    default_float_dtype: str = "f8"
    default_float_value: float = np.nan
    core_parameters: List[str] = field(
        default_factory=lambda: ["logP", "logL", "it"]
    )

    @property
    def non_sampling_parameters(self) -> List[str]:
        return list(self.core_parameters)

    @property
    def non_sampling_dtype(self) -> List[str]:
        return [self.default_float_dtype, self.logl_dtype, self.it_dtype]

    @property
    def non_sampling_defaults(self) -> tuple:
        return (
            self.default_float_value,
            self.default_float_value,
            self.it_default,
        )


@dataclass
class GeneralConfig:
    eps: float = 1e-8


livepoints = LivepointsConfig()
general = GeneralConfig()
