"""Truncation rules of the flow proposal's populate. Counterpart of
``nessai_tpu/proposal/flowproposal/truncation.py``: the rule base class
and its hooks, the registry, :class:`TruncationScheme` with list and dict
configs, the helpers that normalise the proposal's truncation keywords
(the deprecated latent-radius ones among them), and the three rules:
``latent_radius`` (modes ``adaptive``, ``fixed`` and ``constant_volume``),
``min_log_q`` and ``likelihood_threshold``.

Every rule works on host numpy arrays: the latent draws before the flow
inverse, and ``(x, log_q, z)`` after it and after the likelihood.
"""

import logging
from copy import deepcopy
from typing import List, Optional

import numpy as np

from ...utils.sampling import NDimensionalTruncatedGaussian, compute_radius

logger = logging.getLogger(__name__)

__all__ = [
    "TruncationRule",
    "BaseTruncationRule",
    "LatentRadiusTruncation",
    "MinLogQTruncation",
    "LikelihoodThresholdTruncation",
    "TruncationScheme",
    "TRUNCATION_REGISTRY",
    "DEFAULT_TRUNCATION_METHODS",
    "DEFAULT_TRUNCATION_KWARGS",
    "LEGACY_LATENT_RADIUS_ARGUMENTS",
    "get_truncation_rule",
    "get_truncation_rule_class",
    "normalise_truncation_methods",
    "normalise_truncation_kwargs",
    "should_enable_latent_radius",
    "build_truncation_methods",
    "apply_default_truncation_config",
    "get_deprecated_latent_radius_arguments",
    "get_deprecated_latent_radius_kwargs",
]

#: the default truncation: the latent radius holding 95% of the latent
#: Gaussian's mass
DEFAULT_TRUNCATION_METHODS = ["latent_radius"]
DEFAULT_TRUNCATION_KWARGS = {"latent_radius": {"mode": "constant_volume", "q": 0.95}}

#: the proposal's (deprecated) keywords that configure the latent radius
LEGACY_LATENT_RADIUS_ARGUMENTS = (
    "constant_volume_mode",
    "volume_fraction",
    "fuzz",
    "expansion_fraction",
    "fixed_radius",
    "radius_mode",
    "min_radius",
    "max_radius",
    "compute_radius_with_all",
)


def get_deprecated_latent_radius_arguments(**kwargs) -> List[str]:
    """The deprecated latent-radius keywords set (not None) in ``kwargs``."""
    return [name for name in LEGACY_LATENT_RADIUS_ARGUMENTS if kwargs.get(name) is not None]


def get_deprecated_latent_radius_kwargs(**kwargs) -> dict:
    """The latent-radius keywords set (not None) in ``kwargs``."""
    return {name: kwargs[name] for name in LEGACY_LATENT_RADIUS_ARGUMENTS if kwargs.get(name) is not None}


def normalise_truncation_methods(truncation_method=None, truncation_methods=None) -> List[str]:
    """One method name or a list of them as an ordered list without
    repeats."""
    methods = truncation_methods if truncation_methods is not None else truncation_method
    if methods is None:
        return []
    if isinstance(methods, str):
        methods = [methods]
    return list(dict.fromkeys(methods))


def should_enable_latent_radius(latent_radius_kwargs=None) -> bool:
    """Whether latent-radius keywords turn the rule on."""
    return bool(latent_radius_kwargs)


def build_truncation_methods(
    truncation_method=None,
    truncation_methods=None,
    truncate_log_q: bool = False,
    enforce_likelihood_threshold: bool = False,
    latent_radius_kwargs=None,
    default_latent_radius: bool = False,
) -> List[str]:
    """The method list from the new keywords and the deprecated boolean
    ones: the latent radius first (where asked for), ``min_log_q`` and
    ``likelihood_threshold`` after the named methods."""
    if truncation_method is not None and truncation_methods is not None:
        raise ValueError("Specify only one of truncation_method or truncation_methods")
    methods = normalise_truncation_methods(truncation_method, truncation_methods)
    if (
        default_latent_radius or should_enable_latent_radius(latent_radius_kwargs)
    ) and "latent_radius" not in methods:
        methods.insert(0, "latent_radius")
    if truncate_log_q and "min_log_q" not in methods:
        methods.append("min_log_q")
    if enforce_likelihood_threshold and "likelihood_threshold" not in methods:
        methods.append("likelihood_threshold")
    return methods


def apply_default_truncation_config(methods, truncation_kwargs=None, *, default_latent_radius: bool = False):
    """``(methods, kwargs)`` with the default rule's keywords filled in
    where a method takes them and the user did not set them."""
    if default_latent_radius and not methods:
        methods = list(DEFAULT_TRUNCATION_METHODS)
    else:
        methods = list(methods)
    kwargs = deepcopy(truncation_kwargs or {})
    for name, default_kwargs in DEFAULT_TRUNCATION_KWARGS.items():
        if name not in methods:
            continue
        kwargs.setdefault(name, {})
        if not isinstance(kwargs[name], dict):
            continue
        for key, value in default_kwargs.items():
            kwargs[name].setdefault(key, value)
    return methods, kwargs


def normalise_truncation_kwargs(truncation_method=None, truncation_methods=None, truncation_kwargs=None) -> dict:
    """Truncation keywords keyed by method: flat keywords given with one
    ``truncation_method`` go under its name."""
    if truncation_kwargs is None:
        return {}
    kwargs = deepcopy(truncation_kwargs)
    if (
        isinstance(truncation_method, str)
        and truncation_methods is None
        and truncation_method not in kwargs
        and not any(isinstance(value, dict) for value in kwargs.values())
    ):
        return {truncation_method: kwargs}
    return kwargs


class TruncationRule:
    """A rule hooks into the populate at up to three stages: the latent
    draws (:meth:`apply_latent`, or drawing them itself with
    :meth:`sample_latent`), after the flow inverse
    (:meth:`apply_after_backward`) and after the likelihood
    (:meth:`apply_after_likelihood`). :meth:`prepare` runs at the start
    of every populate."""

    #: the rule's name in the registry
    name = "base"
    #: whether the populate must evaluate the likelihood on every draw
    requires_log_likelihood = False

    def prepare(self, proposal, worst_point, radius=None) -> None:
        """Called at the start of every populate."""

    def apply_latent(self, proposal, z):
        return z

    def apply_after_backward(self, proposal, x, log_q, z):
        return x, log_q, z

    def apply_after_likelihood(self, proposal, x, log_q, z):
        return x, log_q, z

    def sample_latent(self, proposal, n: int):
        """The latent draws of a round, or None to draw from the flow's
        base distribution."""
        return None

    def configure(self, proposal) -> None:
        """Apply any proposal-level configuration the rule needs."""

    def reset(self) -> None:
        pass


#: the name the JAX package also gives the rule base class
BaseTruncationRule = TruncationRule


class LatentRadiusTruncation(TruncationRule):
    """Truncate the latent draws to the ball of radius ``r * fuzz``.

    Modes:
    - ``adaptive``: r is the largest latent radius of the training data's
      forward images (``proposal.training_latent``), and ``fuzz`` grows
      the ball's volume by ``1 + expansion_fraction``;
    - ``fixed``: the user's ``radius``;
    - ``constant_volume``: the chi-PPF radius holding ``q`` of the latent
      Gaussian's mass.

    r is clipped to ``[min_radius, max_radius]``. For a unit-Gaussian base
    the draws inside the ball are exact (inverse-CDF, no rejection); any
    other base is drawn from and cut at the radius.
    """

    name = "latent_radius"

    def __init__(
        self,
        mode: str = "adaptive",
        radius: Optional[float] = None,
        fuzz: float = 1.0,
        expansion_fraction: float = 4.0,
        q: float = 0.95,
        min_radius: float = 0.0,
        max_radius: float = 50.0,
        rng=None,
        radius_mode: Optional[str] = None,
        fixed_radius=None,
        constant_volume_mode: Optional[bool] = None,
        volume_fraction: Optional[float] = None,
        compute_radius_with_all=None,
    ):
        if volume_fraction is not None:
            q = volume_fraction
        if fixed_radius not in (None, False):
            mode = "fixed"
            radius = float(fixed_radius)
        if constant_volume_mode:
            mode = "constant_volume"
        if radius_mode is not None:
            mode = radius_mode
        if compute_radius_with_all is not None:
            logger.warning(
                "compute_radius_with_all is ignored: the adaptive latent radius always encloses the "
                "full training set"
            )
        if mode not in ("adaptive", "fixed", "constant_volume"):
            raise ValueError(f"Unknown latent_radius mode: {mode}")
        self.mode = mode
        self.radius = radius
        self.fuzz = float(fuzz)
        self.expansion_fraction = expansion_fraction
        self.q = q
        self.min_radius = float(min_radius)
        self.max_radius = float(max_radius)
        self.rng = rng
        self.r = radius
        self._dist = None

    def prepare(self, proposal, worst_point, radius=None) -> None:
        dims = proposal.prime_dims
        if self.rng is None:
            self.rng = proposal.rng
        if radius is not None:
            self.r = float(radius)
        elif self.mode == "fixed":
            if self.radius is None:
                raise RuntimeError("fixed mode requires a radius")
            self.r = float(self.radius)
        elif self.mode == "constant_volume":
            self.r = compute_radius(dims, self.q)
        else:
            z_train = proposal.training_latent
            if z_train is None:
                raise RuntimeError("adaptive latent radius requires trained proposal")
            r = float(np.max(np.linalg.norm(np.asarray(z_train), axis=1)))
            if self.expansion_fraction:
                self.fuzz = (1 + self.expansion_fraction) ** (1 / dims)
            self.r = r
        if self.max_radius and self.r > self.max_radius:
            self.r = self.max_radius
        if self.min_radius and self.r < self.min_radius:
            self.r = self.min_radius
        proposal.r = self.r
        self._dist = NDimensionalTruncatedGaussian(dims, self.r, fuzz=self.fuzz, rng=self.rng)
        logger.debug("Latent radius: %.3f (fuzz %.3f)", self.r, self.fuzz)

    def sample_latent(self, proposal, n: int):
        if not getattr(proposal, "latent_is_unit_gaussian", True):
            return None
        return self._dist.sample(n)

    def apply_latent(self, proposal, z):
        keep = np.linalg.norm(z, axis=1) <= self.r * self.fuzz
        return z[keep]

    def reset(self) -> None:
        self._dist = None
        if self.mode != "fixed":
            self.r = None

    @property
    def radius_mode(self) -> str:
        return self.mode

    @property
    def constant_volume_mode(self) -> bool:
        return self.mode == "constant_volume"

    @property
    def volume_fraction(self) -> float:
        return self.q

    @property
    def fixed_radius(self):
        """The fixed radius, or False outside the fixed mode."""
        return self.radius if self.mode == "fixed" else False

    @property
    def threshold(self):
        """The cut ``r * fuzz`` (None before :meth:`prepare`)."""
        return None if self.r is None else self.r * self.fuzz

    def to_kwargs(self) -> dict:
        """The keywords that rebuild the rule."""
        return {
            "mode": self.mode,
            "radius": self.radius,
            "fuzz": self.fuzz,
            "expansion_fraction": self.expansion_fraction,
            "q": self.q,
            "min_radius": self.min_radius,
            "max_radius": self.max_radius,
        }

    def configure(self, proposal) -> None:
        """Fold ``expansion_fraction`` into the fuzz factor at the
        proposal's prime dimension (the adaptive mode also does so at
        every :meth:`prepare`)."""
        if self.expansion_fraction:
            self.fuzz = (1 + self.expansion_fraction) ** (1 / proposal.prime_dims)
            logger.debug("Latent-radius fuzz factor: %.4f", self.fuzz)


class MinLogQTruncation(TruncationRule):
    """Drop draws whose log q is below ``threshold``, by default the
    smallest log q of the training data (``proposal.training_log_q``)."""

    name = "min_log_q"

    def __init__(self, threshold: Optional[float] = None, **kwargs):
        self.threshold = threshold
        self._min_log_q = None

    def prepare(self, proposal, worst_point, radius=None) -> None:
        if self.threshold is not None:
            self._min_log_q = self.threshold
        else:
            log_q = proposal.training_log_q
            if log_q is None:
                raise RuntimeError("min_log_q requires trained proposal")
            self._min_log_q = float(np.min(np.asarray(log_q)))

    def apply_after_backward(self, proposal, x, log_q, z):
        keep = log_q >= self._min_log_q
        return x[keep], log_q[keep], z[keep]

    @property
    def min_log_q(self):
        """The cut (None before :meth:`prepare`)."""
        return self._min_log_q

    def reset(self) -> None:
        self._min_log_q = None


class LikelihoodThresholdTruncation(TruncationRule):
    """Drop draws at or below the worst live point's log-likelihood. The
    populate then evaluates the likelihood on every draw."""

    name = "likelihood_threshold"
    requires_log_likelihood = True

    def __init__(self, **kwargs):
        self._threshold = -np.inf

    def prepare(self, proposal, worst_point, radius=None) -> None:
        if worst_point is not None:
            self._threshold = float(np.atleast_1d(worst_point["logL"])[0])
        else:
            self._threshold = -np.inf

    def apply_after_likelihood(self, proposal, x, log_q, z):
        keep = x["logL"] > self._threshold
        return x[keep], log_q[keep], z[keep]

    @property
    def threshold(self) -> float:
        return self._threshold


TRUNCATION_REGISTRY = {
    "latent_radius": LatentRadiusTruncation,
    "min_log_q": MinLogQTruncation,
    "likelihood_threshold": LikelihoodThresholdTruncation,
}


def get_truncation_rule(name: str):
    """The rule class registered under ``name``."""
    if name not in TRUNCATION_REGISTRY:
        raise ValueError(f"Unknown truncation rule: {name}. Known: {sorted(TRUNCATION_REGISTRY)}")
    return TRUNCATION_REGISTRY[name]


def get_truncation_rule_class(name: str):
    """The rule class registered under ``name``."""
    return get_truncation_rule(name)


class TruncationScheme:
    """The rules of a populate, applied in order at each stage."""

    def __init__(self, rules: Optional[List] = None):
        self.rules = list(rules) if rules else []

    @classmethod
    def from_config(cls, config, rng=None):
        """Build from None, a name, a list of names, or a dict of name ->
        keywords; the latent radius draws from ``rng``."""
        if config is None:
            return cls([])
        if isinstance(config, TruncationScheme):
            return config
        if isinstance(config, str):
            config = {config: {}}
        if isinstance(config, (list, tuple)):
            config = {name: {} for name in config}
        rules = []
        for name, kwargs in config.items():
            rule_cls = get_truncation_rule(name)
            kwargs = dict(kwargs or {})
            if name == "latent_radius":
                kwargs.setdefault("rng", rng)
            rules.append(rule_cls(**kwargs))
        return cls(rules)

    @property
    def rule_names(self):
        return [rule.name for rule in self.rules]

    def has_rule(self, name: str) -> bool:
        return any(rule.name == name for rule in self.rules)

    def get_rule(self, name: str):
        for rule in self.rules:
            if rule.name == name:
                return rule
        return None

    def add_rule(self, rule, index=None) -> None:
        if self.has_rule(rule.name):
            raise ValueError(f"Duplicate truncation rule: {rule.name}")
        if index is None:
            self.rules.append(rule)
        else:
            self.rules.insert(index, rule)

    @property
    def requires_log_likelihood(self) -> bool:
        return any(r.requires_log_likelihood for r in self.rules)

    @property
    def requires_training_latent(self) -> bool:
        """Whether a rule reads the training data's forward images: the
        adaptive latent radius, and ``min_log_q`` without a threshold."""
        return any(
            (r.name == "latent_radius" and r.mode == "adaptive")
            or (r.name == "min_log_q" and r.threshold is None)
            for r in self.rules
        )

    def configure(self, proposal) -> None:
        for r in self.rules:
            r.configure(proposal)

    def prepare(self, proposal, worst_point, radius=None) -> None:
        for r in self.rules:
            r.prepare(proposal, worst_point, radius=radius)

    def sample_latent(self, proposal, n: int):
        """The first rule's latent draws, or None to draw from the flow's
        base distribution."""
        for r in self.rules:
            z = r.sample_latent(proposal, n)
            if z is not None:
                return z
        return None

    def apply_latent(self, proposal, z):
        for r in self.rules:
            z = r.apply_latent(proposal, z)
        return z

    def apply_after_backward(self, proposal, x, log_q, z):
        for r in self.rules:
            x, log_q, z = r.apply_after_backward(proposal, x, log_q, z)
        return x, log_q, z

    def apply_after_likelihood(self, proposal, x, log_q, z):
        for r in self.rules:
            x, log_q, z = r.apply_after_likelihood(proposal, x, log_q, z)
        return x, log_q, z

    def reset(self) -> None:
        for r in self.rules:
            r.reset()
