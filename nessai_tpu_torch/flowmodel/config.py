"""Default flow and training configuration. Counterpart of
``nessai_tpu/flowmodel/config.py``."""

from dataclasses import asdict, dataclass, field
from typing import Optional, Union

__all__ = [
    "FlowConfig",
    "TrainingConfig",
    "update_flow_config",
    "update_training_config",
    "flow_config_to_dict",
]


@dataclass
class FlowConfig:
    ftype: str = "realnvp"
    n_inputs: Optional[int] = None
    n_blocks: int = 4
    n_layers: int = 2
    n_neurons: Union[int, str, None] = None
    distribution: Optional[str] = None
    distribution_kwargs: Optional[dict] = None
    seed: int = 0
    kwargs: dict = field(default_factory=dict)


@dataclass
class TrainingConfig:
    lr: float = 1e-3
    annealing: bool = False
    clip_grad_norm: float = 5.0
    batch_size: Union[int, str] = 1000
    max_epochs: int = 500
    patience: int = 20
    val_size: Optional[float] = 0.1
    optimiser: str = "adamw"
    optimiser_kwargs: dict = field(default_factory=dict)
    noise_type: Optional[str] = None
    noise_scale: float = 0.0
    #: the data-dependent ActNorm initialisation at the first training
    use_actnorm_init: bool = True


def _update(cls, config):
    if config is None:
        return cls()
    if isinstance(config, cls):
        return config
    known = set(cls.__dataclass_fields__)
    base = cls()
    extra = {}
    for k, v in dict(config).items():
        if k in known:
            setattr(base, k, v)
        else:
            extra[k] = v
    if extra:
        if hasattr(base, "kwargs"):
            base.kwargs = {**base.kwargs, **extra}
        else:
            raise ValueError(
                f"{cls.__name__} keys not in the PyTorch port: {sorted(extra)}"
            )
    return base


def update_flow_config(config) -> FlowConfig:
    """Merge a user dict onto the defaults; unknown keys go into
    ``kwargs`` (passed to the architecture builder)."""
    return _update(FlowConfig, config)


def update_training_config(config) -> TrainingConfig:
    """Merge a user dict onto the defaults. ``noise_type`` needs a
    ``noise_scale``; a float ``noise_scale`` alone means constant
    noise."""
    if config is not None and not isinstance(config, (dict, TrainingConfig)):
        raise TypeError("Must pass a dictionary to update the default model config")
    if isinstance(config, dict):
        if config.get("noise_type") is not None and config.get("noise_scale") is None:
            raise RuntimeError("`noise_scale` must be specified when `noise_type` is given.")
        ns = config.get("noise_scale")
        if ns is not None and not isinstance(ns, float):
            raise TypeError(f"`noise_scale` must be a float. Got type: {type(ns)}")
        if isinstance(ns, float) and config.get("noise_type") is None:
            config = dict(config, noise_type="constant")
    cfg = _update(TrainingConfig, config)
    if cfg.noise_type is not None and cfg.noise_type not in ("constant", "adaptive"):
        raise ValueError(f"Unknown noise_type: {cfg.noise_type}")
    if isinstance(cfg.batch_size, str) and cfg.batch_size != "all":
        raise ValueError(f"Unknown batch_size: {cfg.batch_size}")
    return cfg


def flow_config_to_dict(cfg: FlowConfig) -> dict:
    d = asdict(cfg)
    d.update(d.pop("kwargs", {}))
    return d
