"""Dependency-aware ordering of reparameterisations. Counterpart of
``nessai_tpu/utils/sorting.py``."""

from typing import List, Optional

__all__ = ["sort_reparameterisations"]


def sort_reparameterisations(
    reparameterisations: List,
    existing_parameters: Optional[List[str]] = None,
    existing_prime_parameters: Optional[List[str]] = None,
    known_parameters: Optional[List[str]] = None,
    known_prime_parameters: Optional[List[str]] = None,
    initial_sort: bool = True,
) -> List:
    """Topologically order reparameterisations so every one's required
    parameters are produced by earlier entries.

    Each entry must expose ``parameters`` and ``requires`` lists. Raises
    if no valid ordering exists. The ``existing_*`` lists seed the
    available-parameter set, the ``known_*`` lists are parameters that
    exist but are not produced by any entry, and ``initial_sort``
    pre-sorts entries by how many requirements are already satisfied.
    """
    produced = list(existing_parameters or [])
    for extra in (existing_prime_parameters, known_parameters, known_prime_parameters):
        if extra:
            produced += [p for p in extra if p not in produced]

    queue = list(reparameterisations)
    if initial_sort:
        queue.sort(
            key=lambda r: sum(req not in produced for req in (getattr(r, "requires", []) or []))
        )
    ordered = []
    stall = 0
    while queue:
        r = queue.pop(0)
        requires = list(getattr(r, "requires", []) or [])
        if all(req in produced for req in requires):
            ordered.append(r)
            produced += [p for p in r.parameters if p not in produced]
            for p in getattr(r, "prime_parameters", []) or []:
                if p not in produced:
                    produced.append(p)
            stall = 0
        else:
            queue.append(r)
            stall += 1
            if stall > len(queue):
                missing = [req for req in requires if req not in produced]
                raise ValueError(
                    "Could not sort reparameterisations: "
                    f"{r} requires inputs {missing} which are never produced"
                )
    return ordered
