"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, bound with ``ctypes``. Libraries go to
``nessai_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when a
module is imported: :func:`load` runs inside the first launch. ptxas's
report of each kernel (registers, spills) is kept beside its library and
read back by :func:`resources`.
"""

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = [
    "CSRC",
    "BUILD_DIR",
    "NVCC_FLAGS",
    "KERNELS",
    "build",
    "build_all",
    "load",
    "resources",
    "parse_ptxas",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: The sources under ``csrc/``, one library each.
KERNELS = ("affine_coupling", "rqs", "ns_scan")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        candidate = candidate / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA toolkit is needed to build the "
            "port's kernels (on PATH, or under $CUDA_HOME/bin)"
        )
    return nvcc


def _library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _report_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.txt")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built; returns the path."""
    target = _library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu "
            f"(exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    _report_path(target).write_text(proc.stderr)
    os.replace(tmp, target)
    return target


def build_all(names=KERNELS) -> dict:
    """Build every named source at once, one nvcc process each; returns
    ``{name: path}``."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def _kernel_name(mangled: str) -> str:
    """``rqs_forward_kernel<8, 1>`` from the mangled name of a kernel, in
    an anonymous namespace or none, with integer or bool template
    arguments."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled.startswith("_ZN")
    rest = mangled[3 if nested else 2 :]
    name = mangled
    while True:
        digits = re.match(r"\d+", rest)
        if digits is None:
            break
        end = digits.end() + int(digits.group())
        token, rest = rest[digits.end() : end], rest[end:]
        if not token.startswith("_GLOBAL__N"):
            name = token
        if not nested:
            break
    args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
    if args is None:
        return name
    return f"{name}<{', '.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>"


def parse_ptxas(report: str) -> list:
    """Each kernel of an ``nvcc -Xptxas=-v`` report: ``{"kernel",
    "registers", "spill_store_bytes", "spill_load_bytes"}``."""
    spills = {
        m.group(1): (int(m.group(2)), int(m.group(3)))
        for m in re.finditer(
            r"Function properties for (\w+)\s+\d+ bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            report,
        )
    }
    kernels = []
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", report, re.S):
        store, load_ = spills.get(m.group(1), (None, None))
        kernels.append(
            dict(
                kernel=_kernel_name(m.group(1)),
                registers=int(m.group(2)),
                spill_store_bytes=store,
                spill_load_bytes=load_,
            )
        )
    return kernels


def resources(name: str) -> list:
    """ptxas's registers and spills of each kernel in ``csrc/<name>.cu``,
    building it first if needed."""
    return parse_ptxas(_report_path(build(name)).read_text())
