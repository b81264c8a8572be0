"""Introspection of sampler settings for external pipelines.

Counterpart of ``nessai_tpu/utils/settings.py``.
"""

import inspect
from typing import Any, Dict

__all__ = [
    "get_all_kwargs",
    "get_standard_methods",
    "get_run_kwargs_list",
]


def _get_kwargs(func) -> Dict[str, Any]:
    """Default-kwargs of a function, walking the MRO for ``__init__``
    methods so parent-class kwargs (reached via **kwargs) are included."""
    out: Dict[str, Any] = {}
    funcs = [func]
    owner = getattr(func, "__qualname__", "").split(".")[0]
    if getattr(func, "__name__", "") == "__init__":
        import sys

        mod = sys.modules.get(func.__module__)
        cls = getattr(mod, owner, None)
        if cls is not None:
            funcs = [
                k.__init__
                for k in inspect.getmro(cls)
                if "__init__" in k.__dict__
            ]
    for f in reversed(funcs):
        sig = inspect.signature(f)
        out.update(
            {
                name: p.default
                for name, p in sig.parameters.items()
                if p.default is not inspect.Parameter.empty
            }
        )
    return out


def get_standard_methods():
    """Methods whose kwargs make up the standard-sampler configuration."""
    from ..flowsampler import FlowSampler
    from ..proposal.flowproposal import FlowProposal
    from ..samplers.nestedsampler import NestedSampler

    return [FlowProposal.__init__, NestedSampler.__init__, FlowSampler.__init__]


def get_importance_methods():
    """Methods whose kwargs make up the importance-sampler configuration."""
    from ..flowsampler import FlowSampler
    from ..proposal.importance import ImportanceFlowProposal
    from ..samplers.importancesampler import ImportanceNestedSampler

    return [
        ImportanceFlowProposal.__init__,
        ImportanceNestedSampler.__init__,
        FlowSampler.__init__,
    ]


def get_all_kwargs(
    importance_nested_sampler: bool = False,
    split_kwargs: bool = False,
):
    """All keyword arguments and defaults for a sampler configuration."""
    methods = (
        get_importance_methods()
        if importance_nested_sampler
        else get_standard_methods()
    )
    if split_kwargs:
        return [_get_kwargs(m) for m in methods]
    out: Dict[str, Any] = {}
    for m in methods:
        out.update(_get_kwargs(m))
    out.pop("kwargs", None)
    return out


def get_run_kwargs_list(importance_nested_sampler: bool = False):
    """Kwargs accepted by ``FlowSampler.run``."""
    from ..flowsampler import FlowSampler

    func = (
        FlowSampler.run_importance_nested_sampler
        if importance_nested_sampler
        else FlowSampler.run_standard_sampler
    )
    return list(_get_kwargs(func).keys())
