"""Reparameterisations and their registry. Counterpart of
``nessai_tpu/reparameterisations`` (z-score and identity so far)."""

from .base import Reparameterisation
from .combined import CombinedReparameterisation
from .null import IdentityReparameterisation, NullReparameterisation
from .rescale import ScaleAndShift
from .utils import (
    KnownReparameterisation,
    ReparameterisationDict,
    get_reparameterisation,
)

__all__ = [
    "Reparameterisation",
    "CombinedReparameterisation",
    "IdentityReparameterisation",
    "NullReparameterisation",
    "ScaleAndShift",
    "KnownReparameterisation",
    "ReparameterisationDict",
    "get_reparameterisation",
    "default_reparameterisations",
]

default_reparameterisations = ReparameterisationDict()
_add = default_reparameterisations.add_reparameterisation
_add("scaleandshift", ScaleAndShift)
for _name in ("zscore", "standardize", "z-score"):
    _add(_name, ScaleAndShift, {"estimate_scale": True, "estimate_shift": True})
_add("none", NullReparameterisation)
_add("null", NullReparameterisation)
_add(None, NullReparameterisation)
