"""Stopping criteria registry and composable criterion groups.
Counterpart of ``nessai_tpu/stopping_criteria.py`` (host only, copied as
it is): the importance nested sampler looks its criteria up by name.
"""

import logging
import operator
from typing import List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "StoppingCriterionRegistry",
    "StoppingCriterion",
    "CriterionGroup",
]

_OPERATORS = {
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "==": operator.eq,
}


class StoppingCriterion:
    """A single named stopping criterion: stop when
    ``comparison(value, tolerance)`` is true."""

    name: str = None
    aliases: tuple = ()
    default_tolerance: float = 0.0
    comparison_basis: str = "<="

    def __init__(self, tolerance: Optional[float] = None, comparison: Optional[str] = None):
        self.tolerance = (
            self.default_tolerance if tolerance is None else float(tolerance)
        )
        self.comparison = comparison or self.comparison_basis
        self._op = _OPERATORS[self.comparison]

    def is_met(self, value) -> bool:
        if value is None:
            return False
        return bool(self._op(value, self.tolerance))

    def __and__(self, other):
        return CriterionGroup([self]) & other

    def __or__(self, other):
        return CriterionGroup([self]) | other

    def __repr__(self):
        return f"{self.name}{self.comparison}{self.tolerance}"


class CriterionGroup:
    """Composable group of criteria with 'and'/'or' semantics."""

    def __init__(self, criteria: List[StoppingCriterion], mode: str = "and"):
        self.criteria = list(criteria)
        self.mode = mode

    @property
    def names(self):
        return [c.name for c in self.criteria]

    @property
    def tolerances(self):
        return {c.name: c.tolerance for c in self.criteria}

    def is_met(self, values: dict) -> bool:
        flags = [c.is_met(values.get(c.name)) for c in self.criteria]
        return all(flags) if self.mode == "and" else any(flags)

    def _merge(self, other, mode):
        if isinstance(other, StoppingCriterion):
            other = CriterionGroup([other])
        if self.mode == mode and other.mode == mode:
            return CriterionGroup(self.criteria + other.criteria, mode)
        return CriterionGroup(self.criteria + other.criteria, mode)

    def __and__(self, other):
        return self._merge(other, "and")

    def __or__(self, other):
        return self._merge(other, "or")

    def __repr__(self):
        joiner = " & " if self.mode == "and" else " | "
        return joiner.join(map(repr, self.criteria))


class StoppingCriterionRegistry:
    """String-name registry, including aliases."""

    _registry = {}

    @classmethod
    def register(cls, *names):
        def wrapper(criterion_cls):
            for name in (criterion_cls.name, *names):
                if name is not None:
                    cls._registry[name.lower()] = criterion_cls
            return criterion_cls

        return wrapper

    @classmethod
    def list_available(cls):
        return list(cls._registry.keys())

    @classmethod
    def get(cls, name: str, **kwargs) -> StoppingCriterion:
        key = name.lower()
        if key not in cls._registry:
            raise ValueError(
                f"Unknown stopping criterion: {name}. "
                f"Known: {sorted(cls._registry)}"
            )
        return cls._registry[key](**kwargs)

    @classmethod
    def known(cls):
        return sorted(cls._registry)


@StoppingCriterionRegistry.register("dZ", "evidence", "dlogZ")
class DeltaLogZ(StoppingCriterion):
    """Remaining-evidence estimate; standard-sampler default (tol 0.1)."""

    name = "difference_log_evidence"
    default_tolerance = 0.1
    comparison_basis = "<="


@StoppingCriterionRegistry.register("ratio", "evidence_ratio")
class Ratio(StoppingCriterion):
    """INS default: log ratio of live-point to nested-sample evidence
    (tol 0.0)."""

    name = "log_evidence_ratio"
    default_tolerance = 0.0
    comparison_basis = "<="


@StoppingCriterionRegistry.register("ratio_ns")
class RatioNS(StoppingCriterion):
    name = "log_evidence_ratio_nested_samples"
    default_tolerance = 0.0
    comparison_basis = "<="


@StoppingCriterionRegistry.register("effective_sample_size")
class ESS(StoppingCriterion):
    name = "ess"
    default_tolerance = 5000.0
    comparison_basis = ">="


@StoppingCriterionRegistry.register("Z_err", "log_evidence_error")
class ZErr(StoppingCriterion):
    name = "evidence_error"
    default_tolerance = 0.1
    comparison_basis = "<="


@StoppingCriterionRegistry.register()
class FractionalError(StoppingCriterion):
    name = "fractional_error"
    default_tolerance = 0.01
    comparison_basis = "<="


@StoppingCriterionRegistry.register("delta_log_likelihood")
class DeltaLogLikelihood(StoppingCriterion):
    name = "dlogL"
    default_tolerance = 0.0
    comparison_basis = "<="


# ----------------------------------------------------------------------
# Class names after the canonical criterion names, as the JAX package
# has them
# ----------------------------------------------------------------------
DifferenceLogEvidence = DeltaLogZ
LogEvidenceRatio = Ratio
LogEvidenceRatioNestedSamples = RatioNS
EvidenceError = ZErr

__all__ += [
    "DifferenceLogEvidence",
    "LogEvidenceRatio",
    "LogEvidenceRatioNestedSamples",
    "EvidenceError",
    "DeltaLogZ",
    "Ratio",
    "RatioNS",
    "ESS",
    "ZErr",
    "FractionalError",
    "DeltaLogLikelihood",
]
