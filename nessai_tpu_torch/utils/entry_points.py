"""Entry-point plugin loading. Counterpart of
``nessai_tpu/utils/entry_points.py``."""

from importlib.metadata import entry_points

__all__ = ["get_entry_points"]


def get_entry_points(group: str) -> dict:
    """Load all entry points in ``group`` as a name->EntryPoint dict."""
    return {ep.name: ep for ep in entry_points(group=group)}
