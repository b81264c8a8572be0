"""Reparameterisation registry. Counterpart of
``nessai_tpu/reparameterisations/utils.py`` (``KnownReparameterisation``,
``ReparameterisationDict``, ``get_reparameterisation``)."""

import copy
from dataclasses import dataclass, field
from typing import Type

from .base import Reparameterisation

__all__ = [
    "KnownReparameterisation",
    "ReparameterisationDict",
    "get_reparameterisation",
]


@dataclass
class KnownReparameterisation:
    name: str
    class_fn: Type[Reparameterisation]
    keyword_arguments: dict = field(default_factory=dict)


class ReparameterisationDict(dict):
    """Registry of named reparameterisations."""

    def add_reparameterisation(self, name, class_fn, keyword_arguments=None):
        if name in self:
            raise ValueError(f"Reparameterisation {name} already registered")
        self[name] = KnownReparameterisation(name, class_fn, keyword_arguments or {})


def get_reparameterisation(reparameterisation, defaults=None):
    """Resolve a name (or class) to ``(class, kwargs)``."""
    if defaults is None:
        from . import default_reparameterisations

        defaults = default_reparameterisations
    if reparameterisation is None or isinstance(reparameterisation, str):
        known = defaults.get(reparameterisation)
        if known is None:
            raise ValueError(
                f"Unknown reparameterisation: {reparameterisation}. Known "
                f"reparameterisations are: {list(defaults.keys())}."
            )
        return known.class_fn, copy.deepcopy(known.keyword_arguments)
    if isinstance(reparameterisation, type) and issubclass(
        reparameterisation, Reparameterisation
    ):
        return reparameterisation, {}
    raise TypeError(
        f"Reparameterisation must be a str, None, or class; got {reparameterisation}"
    )
