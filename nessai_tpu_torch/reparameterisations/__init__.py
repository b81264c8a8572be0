"""Reparameterisations and their registry. Counterpart of
``nessai_tpu/reparameterisations/__init__.py``: the same names, classes
and keyword arguments."""

from .angle import Angle, AnglePair, ToCartesian
from .base import Reparameterisation
from .combined import CombinedReparameterisation
from .discrete import Dequantise
from .null import IdentityReparameterisation, NullReparameterisation
from .rescale import PrePostRescalingMixin, Rescale, RescaleToBounds, ScaleAndShift
from .utils import (
    KnownReparameterisation,
    ReparameterisationDict,
    ReparameterisationError,
    ReparameterisationSpec,
    build_reparameterisation_spec,
    get_reparameterisation,
    normalise_reparameterisation_spec,
    parse_reparameterisations,
    resolve_reparameterisation_parameters,
)

__all__ = [
    "Angle",
    "AnglePair",
    "ToCartesian",
    "Reparameterisation",
    "CombinedReparameterisation",
    "Dequantise",
    "IdentityReparameterisation",
    "NullReparameterisation",
    "Rescale",
    "RescaleToBounds",
    "ScaleAndShift",
    "KnownReparameterisation",
    "PrePostRescalingMixin",
    "ReparameterisationError",
    "ReparameterisationSpec",
    "build_reparameterisation_spec",
    "get_reparameterisation",
    "normalise_reparameterisation_spec",
    "parse_reparameterisations",
    "resolve_reparameterisation_parameters",
    "default_reparameterisations",
]

default_reparameterisations = ReparameterisationDict()
_add = default_reparameterisations.add_reparameterisation

_add("default", RescaleToBounds)
_add("rescaletobounds", RescaleToBounds)
_add("rescale-to-bounds", RescaleToBounds)
_add("offset", RescaleToBounds, {"offset": True})
_add(
    "inversion",
    RescaleToBounds,
    {"detect_edges": True, "boundary_inversion": True, "inversion_type": "split"},
)
_add(
    "inversion-duplicate",
    RescaleToBounds,
    {
        "detect_edges": True,
        "boundary_inversion": True,
        "inversion_type": "duplicate",
    },
)
_add(
    "logit",
    RescaleToBounds,
    {
        "rescale_bounds": [0.0, 1.0],
        "update_bounds": False,
        "post_rescaling": "logit",
    },
)
_add(
    "log-rescale",
    RescaleToBounds,
    {
        "rescale_bounds": [0.0, 1.0],
        "update_bounds": False,
        "post_rescaling": "log",
    },
)
_add("scale", Rescale)
_add("scaleandshift", ScaleAndShift)
_add("rescale", Rescale)
for _name in ("zscore", "standardize", "z-score"):
    _add(_name, ScaleAndShift, {"estimate_scale": True, "estimate_shift": True})
for _name in ("zscore-gaussian-cdf", "z-score-gaussian-cdf"):
    _add(
        _name,
        ScaleAndShift,
        {
            "estimate_scale": True,
            "estimate_shift": True,
            "post_rescaling": "gaussian_cdf",
        },
    )
for _name in ("z-score-logit", "zscore-logit"):
    _add(
        _name,
        ScaleAndShift,
        {
            "estimate_scale": True,
            "estimate_shift": True,
            "pre_rescaling": "logit",
        },
    )
for _name in ("z-score-inv-gaussian-cdf", "zscore-inv-gaussian-cdf"):
    _add(
        _name,
        ScaleAndShift,
        {
            "estimate_scale": True,
            "estimate_shift": True,
            "pre_rescaling": "inv_gaussian_cdf",
        },
    )
for _name in ("log-z-score", "log-standardise"):
    _add(
        _name,
        ScaleAndShift,
        {"estimate_scale": True, "estimate_shift": True, "pre_rescaling": "log"},
    )
_add("angle", Angle, {})
_add("angle-pi", Angle, {"scale": 2.0})
_add("angle-2pi", Angle, {"scale": 1.0})
_add("angle-sine", RescaleToBounds)
_add("angle-cosine", RescaleToBounds)
_add("angle-pair", AnglePair)
_add("periodic", Angle, {"scale": None})
_add("to-cartesian", ToCartesian)
_add("dequantise", Dequantise)
_add(
    "dequantise-logit",
    Dequantise,
    {
        "rescale_bounds": [0.0, 1.0],
        "update_bounds": False,
        "post_rescaling": "logit",
    },
)
_add("none", NullReparameterisation)
_add("null", NullReparameterisation)
_add(None, NullReparameterisation)

# plugins: the ``nessai`` group first, then the package's own, which
# overwrites on a name clash (later group wins); a plugin that fails to
# load is skipped with a warning
default_reparameterisations.add_external_reparameterisations("nessai.reparameterisations")
default_reparameterisations.add_external_reparameterisations("nessai_tpu_torch.reparameterisations")
