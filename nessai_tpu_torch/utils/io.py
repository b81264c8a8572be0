"""Result and checkpoint files: JSON encoding, atomic dumps with
``.old`` rotation, HDF5. Counterpart of ``nessai_tpu/utils/io.py``;
``h5py`` is imported only where an HDF5 file is written."""

import json
import os
import pickle
import shutil
from typing import Any

import numpy as np

__all__ = [
    "NessaiJSONEncoder",
    "is_jsonable",
    "safe_file_dump",
    "save_to_json",
    "save_dict_to_hdf5",
    "add_dict_to_hdf5_file",
    "encode_for_hdf5",
    "save_live_points",
]


def is_jsonable(x: Any) -> bool:
    """Whether ``json.dumps`` takes ``x`` as it is."""
    try:
        json.dumps(x)
        return True
    except (TypeError, OverflowError):
        return False


class NessaiJSONEncoder(json.JSONEncoder):
    """JSON encoder for numpy scalars and arrays (and anything with a
    ``tolist``, such as a tensor); callables, classes and other objects
    become their ``str``."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if hasattr(obj, "tolist"):
            return obj.tolist()
        if callable(obj) or isinstance(obj, type):
            return str(obj)
        if not is_jsonable(obj):
            return str(obj)
        return super().default(obj)


def safe_file_dump(data, filename, module=pickle, save_existing: bool = False):
    """Dump ``data`` to ``filename`` through a temporary file and a
    rename; with ``save_existing`` an existing file first moves to
    ``<filename>.old``."""
    filename = str(filename)
    if save_existing and os.path.exists(filename):
        shutil.move(filename, filename + ".old")
    tmp = filename + ".temp"
    with open(tmp, "wb") as f:
        module.dump(data, f)
    shutil.move(tmp, filename)


def save_to_json(d: dict, filename, **kwargs) -> None:
    """Write ``d`` as indented JSON with :class:`NessaiJSONEncoder`."""
    kwargs.setdefault("indent", 4)
    kwargs.setdefault("cls", NessaiJSONEncoder)
    with open(filename, "w") as f:
        json.dump(d, f, **kwargs)


def encode_for_hdf5(key, value):
    """A value HDF5 can store: None as ``"__none__"``, numbers, strings
    and arrays as they are, numeric lists as arrays, anything else as
    its ``str``."""
    if value is None:
        return "__none__"
    if isinstance(value, (int, float, str, bytes, np.ndarray, np.generic)):
        return value
    if isinstance(value, (list, tuple)):
        arr = np.asarray(value)
        if arr.dtype.kind in "ifub":
            return arr
        return str(value)
    if hasattr(value, "tolist"):
        return np.asarray(value)
    return str(value)


def add_dict_to_hdf5_file(hdf5_file, path: str, d: dict) -> None:
    """Write a dict into an open ``h5py`` file, one group per nested
    dict."""
    for key, value in d.items():
        full = path + str(key)
        if isinstance(value, dict):
            hdf5_file.create_group(full)
            add_dict_to_hdf5_file(hdf5_file, full + "/", value)
        else:
            try:
                hdf5_file[full] = encode_for_hdf5(key, value)
            except TypeError:
                hdf5_file[full] = str(value)


def save_dict_to_hdf5(d: dict, filename) -> None:
    """Write ``d`` to an HDF5 file (needs ``h5py``)."""
    import h5py

    with h5py.File(filename, "w") as f:
        add_dict_to_hdf5_file(f, "/", d)


def save_live_points(live_points, filename) -> None:
    """Save live points as JSON, one list per field."""
    from ..livepoint import live_points_to_dict

    with open(filename, "w") as wf:
        json.dump(live_points_to_dict(live_points), wf, indent=4, cls=NessaiJSONEncoder)
