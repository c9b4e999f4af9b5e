"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one is reused.
Nothing is built when this module is imported: :func:`library` builds on
first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcaesar_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile ``csrc/*.cu`` unless the hashed library already exists.
    Returns (library path, compiler messages: ptxas's register and
    shared-memory use; empty when nothing was built)."""
    out = library_path()
    if out.is_file():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    lib = ctypes.CDLL(str(build()[0]))
    lib.caesar_nms.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P]
    lib.caesar_nms.restype = _I
    lib.caesar_roi_align.argtypes = [_P] * 4 + [_I] * 10 + [_P, _P, _I, _I, _I, _P, _P]
    lib.caesar_roi_align.restype = _I
    return lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
