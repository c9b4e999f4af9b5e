"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. Its one caller is
``library.py``, whose ``CUDA`` implementations of the ``caesar`` operators
pass it the tensors' addresses and the current stream. The library lands
in ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused. Nothing is built when this module is imported: :func:`library`
builds on first use.
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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
    for src in sorted(CSRC.glob("*.cu*")):  # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libcaesar_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with the compiler's messages if
    any fails. Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, c, o in zip(procs, cmds, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> tuple:
    """Compile ``csrc/*.cu`` unless the hashed library already exists: one
    nvcc per source, all started together, then one link. Returns (library
    path, compiler messages: ptxas's register and shared-memory use; empty
    when nothing was built)."""
    out = library_path()
    if out.is_file():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, out.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a concurrent build never sees a partial file
    return out, log


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build if needed and load once."""
    return load(build()[0])


def load(path) -> ctypes.CDLL:
    """Load a built library and declare every entry point."""
    lib = ctypes.CDLL(str(path))
    lib.caesar_nms.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P, _P]
    lib.caesar_nms.restype = _I
    lib.caesar_roi_align.argtypes = [_P] * 4 + [_I] * 10 + [_P, _I, _I, _F, _I, _I, _P, _P]
    lib.caesar_roi_align.restype = _I
    lib.caesar_roi_align_backward.argtypes = [_P] * 4 + [_I] * 10 + [_P, _I, _I, _F, _I, _P, _P]
    lib.caesar_roi_align_backward.restype = _I
    lib.caesar_crop_and_resize.argtypes = [_P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P]
    lib.caesar_crop_and_resize.restype = _I
    lib.caesar_conv2d_int8_wgmma.argtypes = [_P] * 7 + [_I] * 13 + [_F, _I, _I, _I, _P]
    lib.caesar_conv2d_int8_wgmma.restype = _I
    lib.caesar_conv_int8_weight_map.argtypes = [_P, _P, _I, _I, _I]
    lib.caesar_conv_int8_weight_map.restype = _I
    lib.caesar_quantize_int8.argtypes = [_P, _P, ctypes.c_longlong, _I, _F, _P]
    lib.caesar_quantize_int8.restype = _I
    lib.caesar_quantize_int8_pad.argtypes = [_P, _P, ctypes.c_longlong, _I, _I, _I, _F, _P]
    lib.caesar_quantize_int8_pad.restype = _I
    lib.caesar_paste_masks.argtypes = [_P, _P] + [_I] * 6 + [_P, _I, _P]
    lib.caesar_paste_masks.restype = _I
    return lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
