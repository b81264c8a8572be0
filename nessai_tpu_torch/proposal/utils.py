"""The flow proposal classes by name and the check of their keyword
arguments. Counterpart of ``nessai_tpu/proposal/utils.py``."""

import inspect
import logging

logger = logging.getLogger(__name__)

__all__ = [
    "available_base_flow_proposal_classes",
    "available_external_flow_proposal_classes",
    "get_flow_proposal_class",
    "check_proposal_kwargs",
    "PROPOSAL_ENTRY_POINT_GROUPS",
]

#: entry-point groups scanned for plugin proposals, the later winning a
#: name that both hold
PROPOSAL_ENTRY_POINT_GROUPS = ("nessai.proposals", "nessai_tpu_torch.proposals")

#: the JAX package's proposals of ``experimental/`` (ROADMAP §1 item 9),
#: with their own keyword arguments, which other classes tolerate
NOT_PORTED = {
    "mcmcflowproposal": (),
    "clusteringflowproposal": ("max_clusters", "max_n_clusters"),
}


def _known_classes() -> dict:
    from .augmented import AugmentedFlowProposal
    from .flowproposal import FlowProposal

    return {
        None: FlowProposal,
        "flowproposal": FlowProposal,
        "defaultflowproposal": FlowProposal,
        "augmentedflowproposal": AugmentedFlowProposal,
    }


def available_base_flow_proposal_classes() -> dict:
    """The bundled proposal classes by name."""
    return {k: v for k, v in _known_classes().items() if k is not None}


def _external_proposal_entry_points() -> dict:
    from ..utils.entry_points import get_entry_points

    external = {}
    for group in PROPOSAL_ENTRY_POINT_GROUPS:
        external.update(get_entry_points(group))
    return external


def available_external_flow_proposal_classes(load: bool = False) -> dict:
    """The plugin proposal classes of the entry-point groups (loaded with
    ``load``)."""
    external = _external_proposal_entry_points()
    logger.debug("Found external proposals: %s", list(external))
    if load:
        for key in external:
            external[key] = external[key].load()
    return external


def get_flow_proposal_class(proposal_class):
    """A proposal class from None (:class:`FlowProposal`), a name (the
    bundled ones, then the plugins') or a subclass of
    :class:`BaseFlowProposal`."""
    from .flowproposal.base import BaseFlowProposal

    if proposal_class is None:
        return _known_classes()[None]
    if isinstance(proposal_class, type) and issubclass(proposal_class, BaseFlowProposal):
        return proposal_class
    if isinstance(proposal_class, str):
        name = proposal_class.lower()
        classes = _known_classes()
        if name in classes:
            return classes[name]
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"{proposal_class} (the JAX package's experimental/) is not in the PyTorch port yet "
                "(ROADMAP §1 item 9)"
            )
        try:
            eps = _external_proposal_entry_points()
            if name in eps:
                return eps[name].load()
        except Exception:  # pragma: no cover
            pass
        raise ValueError(f"Unknown flow class: {proposal_class}")
    raise TypeError(f"Invalid flow class: {proposal_class}")


def _accepted_kwargs(ProposalClass) -> set:
    """The keyword names of every ``__init__`` in the class's MRO."""
    accepted = set()
    for klass in inspect.getmro(ProposalClass):
        init = getattr(klass, "__init__", None)
        if init is None:
            continue
        try:
            accepted |= set(inspect.signature(init).parameters)
        except (TypeError, ValueError):  # pragma: no cover
            continue
    return accepted


def check_proposal_kwargs(ProposalClass, kwargs, strict: bool = False) -> dict:
    """The ``kwargs`` that ``ProposalClass`` takes. The others: left-out
    defaults (None, {} or []) are dropped; with ``strict`` any other
    raises; a keyword of another proposal class is dropped with a
    warning; an unknown keyword raises."""
    accepted = _accepted_kwargs(ProposalClass)
    out = {k: v for k, v in kwargs.items() if k in accepted}
    real = {
        k: v for k, v in kwargs.items() if k not in accepted and not (v is None or v == {} or v == [])
    }
    if real:
        if strict:
            raise RuntimeError(f"Keyword arguments contain unknown keys: {set(real)}")
        allowed_extra = {k for names in NOT_PORTED.values() for k in names}
        for other in set(_known_classes().values()) - {ProposalClass}:
            allowed_extra |= _accepted_kwargs(other)
        invalid = set(real) - allowed_extra
        if invalid:
            raise RuntimeError(f"Unknown kwargs for {ProposalClass.__name__}: {invalid}.")
        logger.warning(
            "Removing unused keyword arguments (%s) from kwargs for %s. These are valid keyword "
            "arguments but correspond to other proposal classes.",
            set(real),
            ProposalClass.__name__,
        )
    return out
