"""Global configuration: live-point layout and numerical constants.

Counterpart of ``nessai_tpu/config.py``. Of the JAX compute knobs only
the names the port reads or that users set are kept: the data axis of a
device mesh and the dtype name (the port always runs its kernels on
CUDA tensors, in float32).
"""

from dataclasses import asdict, dataclass, field
from typing import List

import numpy as np

__all__ = ["livepoints", "plotting", "general", "compute"]


class _BaseConfig:
    def asdict(self) -> dict:
        """The configuration as a dictionary."""
        return asdict(self)


@dataclass
class LivepointsConfig(_BaseConfig):
    """Configuration for live-point structured arrays. The port derives
    the fields' dtypes and defaults anew at each read, so
    :meth:`reset_properties` has no cache to clear."""

    logl_dtype: str = "f8"
    it_dtype: str = "i4"
    it_default: int = 0
    default_float_dtype: str = "f8"
    default_float_value: float = np.nan
    core_parameters: List[str] = field(
        default_factory=lambda: ["logP", "logL", "it"]
    )
    #: Extra fields (the importance nested sampler adds logW, logQ and
    #: logU at run time, ``livepoint.add_extra_parameters_to_live_points``).
    extra_parameters: List[str] = field(default_factory=list)
    extra_parameters_dtype: List[str] = field(default_factory=list)
    extra_parameters_defaults: tuple = ()

    @property
    def core_parameters_dtype(self) -> List[str]:
        return [self.default_float_dtype, self.logl_dtype, self.it_dtype]

    @property
    def core_parameters_defaults(self) -> tuple:
        return (self.default_float_value, self.default_float_value, self.it_default)

    @property
    def non_sampling_parameters(self) -> List[str]:
        return list(self.core_parameters) + list(self.extra_parameters)

    @property
    def non_sampling_dtype(self) -> List[str]:
        return self.core_parameters_dtype + list(self.extra_parameters_dtype)

    @property
    def non_sampling_defaults(self) -> tuple:
        return self.core_parameters_defaults + tuple(self.extra_parameters_defaults)

    def reset_properties(self) -> None:
        """Nothing to clear: the derived values are not cached."""

    def reset(self) -> None:
        """Remove every extra field."""
        self.extra_parameters = []
        self.extra_parameters_dtype = []
        self.extra_parameters_defaults = ()


@dataclass
class PlottingConfig(_BaseConfig):
    """Plot style (``plot.nessai_style``) and clipping."""

    disable_style: bool = False
    sns_style: str = "ticks"
    base_colour: str = "#02979d"
    highlight_colour: str = "#f5b754"
    line_colours: List[str] = field(
        default_factory=lambda: ["#4575b4", "#d73027", "#fad117", "#ff8c00"]
    )
    line_styles: List[str] = field(
        default_factory=lambda: ["-", "--", ":", "-."]
    )
    max_figsize: float = 50.0
    #: minimum value data is clipped to for plotting
    clip_min: float = -1e10


@dataclass
class GeneralConfig(_BaseConfig):
    eps: float = 1e-8


@dataclass
class ComputeConfig(_BaseConfig):
    """Compute settings (``nessai_tpu/config.py:156-177``)."""

    #: the flows' dtype, a name kept as the JAX package keeps it: both
    #: compute in float32
    default_dtype: str = "float32"
    #: the axis name of a :class:`~nessai_tpu_torch.parallel.Mesh`
    data_axis: str = "data"


livepoints = LivepointsConfig()
plotting = PlottingConfig()
general = GeneralConfig()
compute = ComputeConfig()
