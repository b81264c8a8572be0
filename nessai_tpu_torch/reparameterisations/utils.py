"""Reparameterisation registry helpers and user-config parsing.
Counterpart of ``nessai_tpu/reparameterisations/utils.py``."""

import copy
import logging
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Type

from .base import Reparameterisation

logger = logging.getLogger(__name__)

__all__ = [
    "KnownReparameterisation",
    "ReparameterisationDict",
    "ReparameterisationError",
    "ReparameterisationSpec",
    "get_reparameterisation",
    "normalise_reparameterisation_spec",
    "build_reparameterisation_spec",
    "parse_reparameterisations",
    "resolve_reparameterisation_parameters",
]


class ReparameterisationError(RuntimeError):
    """Exception for reparameterisation errors."""


@dataclass
class KnownReparameterisation:
    name: str
    class_fn: Type[Reparameterisation]
    keyword_arguments: dict = field(default_factory=dict)


@dataclass
class ReparameterisationSpec:
    """Normalised representation of a reparameterisation config spec."""

    source_key: str
    spec_index: int
    reparameterisation: Optional[Any]
    source_is_parameter: bool
    input_parameters: Optional[List[str]]
    kwargs: Dict[str, Any] = field(default_factory=dict)


class ReparameterisationDict(dict):
    """Registry of named reparameterisations (+ entry-point plugins)."""

    def add_reparameterisation(self, name, class_fn, keyword_arguments=None):
        if keyword_arguments is None:
            keyword_arguments = {}
        if name in self:
            raise ValueError(f"Reparameterisation {name} already registered")
        self[name] = KnownReparameterisation(name, class_fn, keyword_arguments)

    def add_external_reparameterisations(self, group: str):
        """Register plugins from an entry-point group.

        A broken plugin must not break ``import nessai_tpu_torch`` (this
        runs at import time), so each entry loads inside its own
        try/except and a failure is skipped with a warning. Later groups
        overwrite earlier ones on a name clash: callers scan the
        ``nessai`` group before the package's own, so the package's
        definitions win. Plugins are accepted by shape (``name`` /
        ``class_fn`` / ``keyword_arguments``) rather than by class, so
        entries built against another package's
        ``KnownReparameterisation`` register unchanged.
        """
        from ..utils.entry_points import get_entry_points

        try:
            eps = get_entry_points(group)
        except Exception:  # pragma: no cover
            eps = {}
        for ep in eps.values():
            try:
                known = ep.load()
            except Exception:
                logger.warning(
                    "Could not load reparameterisation entry point %s",
                    ep,
                    exc_info=True,
                )
                continue
            if not all(
                hasattr(known, attr)
                for attr in ("name", "class_fn", "keyword_arguments")
            ):
                logger.warning(
                    "Skipping entry point %s: not a KnownReparameterisation",
                    ep,
                )
                continue
            if known.name in self:
                logger.debug(
                    "Entry point %s overrides reparameterisation %s",
                    ep,
                    known.name,
                )
            self[known.name] = known


def get_reparameterisation(reparameterisation, defaults=None):
    """Resolve a reparameterisation name/class to ``(class, kwargs)``."""
    if defaults is None:
        from . import default_reparameterisations

        defaults = default_reparameterisations
    if reparameterisation is None or isinstance(reparameterisation, str):
        known = defaults.get(reparameterisation)
        if known is None:
            raise ValueError(
                f"Unknown reparameterisation: {reparameterisation}. "
                f"Known reparameterisations are: {list(defaults.keys())}."
            )
        return known.class_fn, copy.deepcopy(known.keyword_arguments)
    if isinstance(reparameterisation, type) and issubclass(
        reparameterisation, Reparameterisation
    ):
        return reparameterisation, {}
    raise TypeError(
        "Reparameterisation must be a str, None, or class; got "
        f"{reparameterisation}"
    )


def normalise_reparameterisation_spec(key, cfg, model_names):
    """Normalise a reparameterisation config entry into a list of spec
    configs.
    """
    if isinstance(cfg, str) or cfg is None:
        return [cfg]
    if isinstance(cfg, dict):
        return [cfg.copy()]
    if isinstance(cfg, list):
        if key in model_names:
            return cfg.copy()
        logger.debug("Assuming list of patterns")
        return [{"input_parameters": cfg.copy()}]
    raise TypeError(
        f"Unknown config type for: {key}. Expected str, dict or list, "
        f"received instance of {type(cfg)}."
    )


def _is_parameter_key(key, model_names):
    """A key counts as a parameter key if it names a model parameter, or
    is a regex that matches one."""
    if key in model_names:
        return [key]
    if not isinstance(key, str):
        return []
    try:
        regex = re.compile(key)
    except re.error:
        return []
    return [n for n in model_names if regex.fullmatch(n)]


def build_reparameterisation_spec(key, spec_cfg, spec_index, model_names):
    """Build a normalised spec from a single config entry.

    Regex parameter keys are matched against the model names.
    """
    matched = _is_parameter_key(key, model_names)
    if matched:
        if isinstance(spec_cfg, str) or spec_cfg is None:
            return ReparameterisationSpec(
                source_key=key,
                spec_index=spec_index,
                reparameterisation=spec_cfg,
                source_is_parameter=True,
                input_parameters=list(matched),
            )
        if not isinstance(spec_cfg, dict):
            raise TypeError(
                f"Unknown config type for: {key}. Expected str, dict or "
                f"list, received instance of {type(spec_cfg)}."
            )
        spec_cfg = spec_cfg.copy()
        if spec_cfg.get("reparameterisation", None) is None:
            raise RuntimeError(
                f"No reparameterisation found for {key}. "
                "Check inputs (and their spelling :)). "
                f"Current keys: {list(spec_cfg.keys())}"
            )
        reparameterisation = spec_cfg.pop("reparameterisation")

        if "input_parameters" in spec_cfg or "parameters" in spec_cfg:
            input_parameters = spec_cfg.pop(
                "input_parameters", spec_cfg.pop("parameters", None)
            )
            if isinstance(input_parameters, str):
                input_parameters = [input_parameters]
            elif input_parameters is None:
                input_parameters = []
            else:
                input_parameters = list(input_parameters)
        else:
            input_parameters = list(matched)

        return ReparameterisationSpec(
            source_key=key,
            spec_index=spec_index,
            reparameterisation=reparameterisation,
            source_is_parameter=True,
            input_parameters=input_parameters,
            kwargs=spec_cfg,
        )

    if isinstance(spec_cfg, str):
        logger.debug("Assuming reparameterisation name and single parameter")
        spec_cfg = {"input_parameters": [spec_cfg]}
    elif isinstance(spec_cfg, list):
        logger.debug("Assuming list of patterns")
        spec_cfg = {"input_parameters": spec_cfg}
    elif not isinstance(spec_cfg, dict):
        raise TypeError(
            f"Unknown config type for: {key}. Expected str or dict, "
            f"received instance of {type(spec_cfg)}."
        )

    spec_cfg = spec_cfg.copy()
    reparameterisation = spec_cfg.pop("reparameterisation", key)
    return ReparameterisationSpec(
        source_key=key,
        spec_index=spec_index,
        reparameterisation=reparameterisation,
        source_is_parameter=False,
        input_parameters=spec_cfg.pop(
            "input_parameters", spec_cfg.pop("parameters", None)
        ),
        kwargs=spec_cfg,
    )


def parse_reparameterisations(reparameterisations, model_names, class_name=None):
    """Parse user reparameterisation config into ordered specs."""
    if reparameterisations is None:
        logger.info(
            "No reparameterisations provided, using default "
            "reparameterisations included in "
            f"{class_name or 'the proposal class'}"
        )
        reparameterisations = {}
    else:
        reparameterisations = copy.deepcopy(reparameterisations)

    if isinstance(reparameterisations, str):
        reparameterisations = {
            reparameterisations: {"input_parameters": list(model_names)}
        }
    elif not isinstance(reparameterisations, dict):
        raise TypeError(
            "Reparameterisations must be a dictionary, string or None, "
            f"received {type(reparameterisations).__name__}"
        )

    specs = []
    for key, cfg in reparameterisations.items():
        spec_configs = normalise_reparameterisation_spec(
            key, cfg, model_names
        )
        for spec_index, spec_cfg in enumerate(spec_configs):
            specs.append(
                build_reparameterisation_spec(
                    key, spec_cfg, spec_index, model_names
                )
            )
    return specs


def resolve_reparameterisation_parameters(parameters, available_parameters):
    """Resolve parameter names or regex patterns for reparameterisations."""
    if parameters is None:
        return None

    if isinstance(parameters, str):
        patterns = [parameters]
    else:
        patterns = list(parameters)

    known_parameters = list(dict.fromkeys(available_parameters))

    matches = []
    for pattern in patterns:
        if pattern in known_parameters:
            matches.append(pattern)
            continue
        regex = re.compile(pattern)
        pattern_matches = list(filter(regex.fullmatch, known_parameters))
        if pattern_matches:
            matches.extend(pattern_matches)
        else:
            logger.warning(
                f"No matches found for pattern: {pattern}. "
                f"Known parameters are: {known_parameters}"
            )

    return list(dict.fromkeys(matches))
