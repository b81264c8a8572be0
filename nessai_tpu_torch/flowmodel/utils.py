"""Flow-model helpers. Counterpart of ``nessai_tpu/flowmodel/utils.py``."""

__all__ = ["update_config"]


def update_config(d):
    """Split a legacy combined config dict into ``(flow_config,
    training_config)``: the training keys go to the training config, a
    nested ``model_config`` dict is merged into the flow config."""
    from .config import TrainingConfig, update_flow_config, update_training_config

    if d is None:
        return update_flow_config(None), update_training_config(None)
    d = dict(d)
    training_keys = set(TrainingConfig.__dataclass_fields__)
    training = {k: d.pop(k) for k in list(d) if k in training_keys}
    nested = d.pop("model_config", None)
    if nested:
        d.update(nested)
    return update_flow_config(d), update_training_config(training)
