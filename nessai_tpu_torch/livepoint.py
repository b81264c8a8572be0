"""Live-point codec: structured NumPy arrays on the host, dense
``[n, dims]`` arrays for the device. Counterpart of
``nessai_tpu/livepoint.py``."""

import logging

import numpy as np

from . import config

logger = logging.getLogger(__name__)

__all__ = [
    "add_extra_parameters_to_live_points",
    "reset_extra_live_points_parameters",
    "get_dtype",
    "empty_structured_array",
    "parameters_to_live_point",
    "numpy_array_to_live_points",
    "live_points_to_array",
    "live_points_to_dict",
    "dict_to_live_points",
    "dataframe_to_live_points",
    "unstructured_view",
]


def add_extra_parameters_to_live_points(parameters, default_values=None):
    """Register extra non-sampling float fields (the importance nested
    sampler's logW, logQ and logU) with their default values."""
    if default_values is None:
        default_values = len(parameters) * [np.nan]
    for p, dv in zip(parameters, tuple(default_values)):
        if p not in config.livepoints.extra_parameters:
            config.livepoints.extra_parameters.append(p)
            config.livepoints.extra_parameters_dtype.append(
                config.livepoints.default_float_dtype
            )
            config.livepoints.extra_parameters_defaults = (
                config.livepoints.extra_parameters_defaults + (dv,)
            )
        else:
            logger.warning(
                "Extra parameter `%s` has already been added. Skipping. "
                "Call `reset_extra_live_points_parameters` to reset the "
                "values and add this parameter.",
                p,
            )


def reset_extra_live_points_parameters():
    """Remove every extra field registered with
    :func:`add_extra_parameters_to_live_points`."""
    config.livepoints.reset()


def get_dtype(names, array_dtype=None, non_sampling_parameters: bool = True) -> np.dtype:
    """Structured dtype with the sampling parameters followed by the
    non-sampling fields (logP, logL, it and any extra fields; none with
    ``non_sampling_parameters=False``)."""
    if array_dtype is None:
        array_dtype = config.livepoints.default_float_dtype
    fields = [(n, array_dtype) for n in names]
    if non_sampling_parameters:
        fields += list(
            zip(
                config.livepoints.non_sampling_parameters,
                config.livepoints.non_sampling_dtype,
            )
        )
    return np.dtype(fields)


def empty_structured_array(n: int, names=None, dtype=None, non_sampling_parameters: bool = True):
    """Structured array of length ``n`` with parameters set to NaN and
    the non-sampling fields set to their defaults (without them where
    ``non_sampling_parameters`` is False)."""
    if dtype is None:
        dtype = get_dtype(names, non_sampling_parameters=non_sampling_parameters)
    elif names is None:
        names = [
            f
            for f in np.dtype(dtype).names
            if f not in config.livepoints.non_sampling_parameters
        ]
    out = np.empty(n, dtype=dtype)
    if n == 0:
        return out
    for name in names:
        out[name] = np.nan
    if non_sampling_parameters:
        for f, v in zip(
            config.livepoints.non_sampling_parameters,
            config.livepoints.non_sampling_defaults,
        ):
            out[f] = v
    return out


def parameters_to_live_point(parameters, names, non_sampling_parameters: bool = True):
    """One live point from a sequence of parameter values (an empty
    array for no values)."""
    if not len(parameters):
        return empty_structured_array(0, names, non_sampling_parameters=non_sampling_parameters)
    out = empty_structured_array(1, names=names, non_sampling_parameters=non_sampling_parameters)
    for n, v in zip(names, parameters):
        out[n] = v
    return out


def numpy_array_to_live_points(array, names):
    """Unstructured ``[n, dims]`` array -> live points."""
    array = np.atleast_1d(np.asarray(array))
    if array.size == 0:
        return empty_structured_array(0, names=names)
    if array.ndim == 1:
        array = array[None, :]
    out = empty_structured_array(array.shape[0], names=names)
    for i, n in enumerate(names):
        out[n] = array[:, i]
    return out


def live_points_to_array(live_points, names=None):
    """Live points -> float64 array ``[n, len(names)]``."""
    if names is None:
        names = [
            f
            for f in live_points.dtype.names
            if f not in config.livepoints.non_sampling_parameters
        ]
    return np.stack(
        [np.asarray(live_points[n], dtype=float) for n in names], axis=-1
    )


def live_points_to_dict(live_points, names=None) -> dict:
    """Live points as a dict of one array per field (``names``, by
    default every field)."""
    if names is None:
        names = live_points.dtype.names
    return {n: np.asarray(live_points[n]) for n in names}


def dict_to_live_points(d: dict, non_sampling_parameters: bool = True):
    """A dict of arrays (one per field) as live points: the keys that are
    not non-sampling fields are the parameters; non-sampling keys fill
    their fields where the dtype has them."""
    names = [k for k in d.keys() if k not in config.livepoints.non_sampling_parameters]
    n = np.atleast_1d(np.asarray(d[names[0]])).size
    out = empty_structured_array(n, names=names, non_sampling_parameters=non_sampling_parameters)
    for k, v in d.items():
        if k in out.dtype.names:
            out[k] = v
    return out


def dataframe_to_live_points(df, non_sampling_parameters: bool = True):
    """A ``pandas.DataFrame`` (one column per field) as live points."""
    return dict_to_live_points(
        {c: df[c].to_numpy() for c in df.columns}, non_sampling_parameters=non_sampling_parameters
    )


def unstructured_view(x, names=None):
    """Zero-copy ``[n, dims]`` view of the parameter fields."""
    from numpy.lib import recfunctions as rfn

    if names is None:
        names = [
            f
            for f in x.dtype.names
            if f not in config.livepoints.non_sampling_parameters
        ]
    return rfn.structured_to_unstructured(x[list(names)], copy=False)
