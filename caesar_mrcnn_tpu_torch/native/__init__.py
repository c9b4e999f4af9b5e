"""ctypes bindings for the native host-path kernels (libfastops.so).

The port's copy of ``caesar_mrcnn_tpu/native``, with the four entry points
the port calls: ``iou_matrix`` and ``rpn_anchor_stats`` (RPN targets,
``models/targets.py``), ``zscale_limits`` and ``stretch_to_u8`` (FITS
preprocessing, ``utils/fits.py`` and ``utils/zscale.py``).

The library is built with ``make`` (``Makefile`` beside this file) at first
use into ``build/native/`` at the repository root, under a file lock so
that concurrent processes build it once, and named by a hash of the source,
the Makefile and the host CPU (the build uses ``-march=native``). Nothing
is built when this module is imported. Every entry point has the JAX
package's numpy fallback for a machine without a compiler;
:func:`available` says whether the library loaded.

Build by hand: ``make -C caesar_mrcnn_tpu_torch/native OUT=/abs/path/libfastops.so``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import logger

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "native"


def _cpu() -> str:
    """The host CPU's model name (the library is built for it)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    h = hashlib.sha256()
    for name in ("fastops.cpp", "Makefile"):
        h.update((_HERE / name).read_bytes())
    h.update(f"{platform.machine()} {_cpu()}".encode())
    return BUILD_DIR / f"libfastops_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Build ``out`` unless it exists; one process at a time builds, the
    others wait on the lock and then find the library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():
            return True
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["make", "-s", "-C", str(_HERE), f"OUT={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)  # atomic: a reader never sees a partial file
            return True
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            logger.debug("native build failed: %s", e)
            return False


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    out = library_path()
    if not out.is_file() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        logger.debug("native load failed: %s", e)
        return None
    lib.iou_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rpn_anchor_stats.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.zscale_limits.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.zscale_limits.restype = ctypes.c_int
    lib.stretch_to_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def iou_matrix(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Native pairwise IoU; falls back to the numpy oracle."""
    lib = _load()
    if lib is None:
        from ..utils.boxes import compute_overlaps

        return compute_overlaps(b1, b2)
    b1 = np.ascontiguousarray(b1, dtype=np.float32)
    b2 = np.ascontiguousarray(b2, dtype=np.float32)
    out = np.empty((b1.shape[0], b2.shape[0]), dtype=np.float64)
    lib.iou_matrix(
        _fptr(b1), b1.shape[0], _fptr(b2), b2.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def rpn_anchor_stats(
    anchors: np.ndarray, gt: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Single-pass anchor<->GT stats for RPN target building.

    Returns ``(anchor_iou_max [A] f32, anchor_iou_argmax [A] i32,
    tie [A] bool)`` where ``tie`` marks the best-anchor-per-GT positive
    set including exact ties (reference: mrcnn/model.py:1583-1595).
    IoU is computed in f32 (vs the f64 numpy oracle: max diff ~1e-7,
    safely inside the 0.3/0.7 match thresholds; tie equality is
    self-consistent because cells and column maxima come from the same
    f32 values). Returns None when the native library is unavailable
    (callers keep their numpy path).
    """
    lib = _load()
    if lib is None:
        return None
    anchors = np.ascontiguousarray(anchors, dtype=np.float32)
    gt = np.ascontiguousarray(gt, dtype=np.float32)
    a = anchors.shape[0]
    amax = np.empty((a,), dtype=np.float32)
    aarg = np.empty((a,), dtype=np.int32)
    tie = np.empty((a,), dtype=np.uint8)
    lib.rpn_anchor_stats(
        _fptr(anchors), a, _fptr(gt), gt.shape[0],
        _fptr(amax),
        aarg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8ptr(tie),
    )
    return amax, aarg, tie.view(bool)


def zscale_limits(
    data: np.ndarray,
    contrast: float = 0.25,
    nsamples: int = 1000,
    max_reject: float = 0.5,
    min_npixels: int = 5,
    krej: float = 2.5,
    max_iterations: int = 5,
) -> Tuple[float, float]:
    lib = _load()
    if lib is None:
        from ..utils.zscale import zscale_limits as np_limits

        return np_limits(data, contrast, nsamples, max_reject, min_npixels,
                         krej, max_iterations)
    flat = np.ascontiguousarray(data, dtype=np.float32).ravel()
    vmin = ctypes.c_double()
    vmax = ctypes.c_double()
    lib.zscale_limits(
        _fptr(flat), flat.size, contrast, nsamples, max_reject,
        min_npixels, krej, max_iterations,
        ctypes.byref(vmin), ctypes.byref(vmax),
    )
    return vmin.value, vmax.value


def stretch_to_u8(data: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """Fused interval map + clip + 255 scale + round to uint8."""
    lib = _load()
    flat = np.ascontiguousarray(data, dtype=np.float32)
    if lib is None:
        if vmax <= vmin:
            return np.zeros(flat.shape, dtype=np.uint8)
        v = np.clip((flat - vmin) / (vmax - vmin), 0.0, 1.0)
        return np.round(v * 255.0).astype(np.uint8)
    out = np.empty(flat.shape, dtype=np.uint8)
    lib.stretch_to_u8(
        _fptr(flat), flat.size, vmin, vmax, _u8ptr(out)
    )
    return out
