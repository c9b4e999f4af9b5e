"""ctypes bindings for the native host-path kernels (libfastops.so).

The port's copy of ``caesar_mrcnn_tpu/native``, with the six entry points
the port calls: ``iou_matrix`` and ``rpn_anchor_stats`` (RPN targets,
``models/targets.py``), ``zscale_limits`` and ``stretch_to_u8`` (FITS
preprocessing, ``utils/fits.py`` and ``utils/zscale.py``), ``mask_iou`` and
``masks_connected`` (the Analyzer's merge, ``analysis/masks.py``); and one
of its own, ``find_contours``, the outer-border tracer that stands where
the JAX package calls ``cv2.findContours`` (``analysis/contours.py``).

The library is built with ``make`` (``Makefile`` beside this file) at first
use into ``build/native/`` at the repository root, under a file lock so
that concurrent processes build it once, and named by a hash of the source,
the Makefile and the host CPU (the build uses ``-march=native``). Nothing
is built when this module is imported. Every entry point has a plain
fallback for a machine without a compiler (the JAX package's numpy ones,
and ``analysis/contours.py::find_contours_plain`` for the tracer);
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
from typing import List, Optional, Tuple

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
    lib.mask_iou.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.mask_iou.restype = ctypes.c_double
    lib.masks_connected.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.masks_connected.restype = ctypes.c_int
    lib.find_contours_external.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.find_contours_external.restype = ctypes.c_int64
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


def mask_iou(m1: np.ndarray, m2: np.ndarray) -> float:
    lib = _load()
    a = np.ascontiguousarray(m1, dtype=np.uint8)
    b = np.ascontiguousarray(m2, dtype=np.uint8)
    if lib is None:
        from ..analysis.masks import mask_iou as np_iou

        return np_iou(a, b)
    return float(lib.mask_iou(_u8ptr(a), _u8ptr(b), a.size))


def masks_connected(m1: np.ndarray, m2: np.ndarray) -> bool:
    lib = _load()
    a = np.ascontiguousarray(m1, dtype=np.uint8)
    b = np.ascontiguousarray(m2, dtype=np.uint8)
    if lib is None:
        from ..analysis.masks import are_masks_connected

        return are_masks_connected(a, b)
    h, w = a.shape
    return bool(lib.masks_connected(_u8ptr(a), _u8ptr(b), h, w))


def find_contours(mask: np.ndarray) -> List[np.ndarray]:
    """Outer borders of the nonzero pixels of a 2-D mask as
    ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)`` lists them:
    int32 ``[N, (x, y)]`` arrays. Falls back to
    ``analysis.contours.find_contours_plain``."""
    lib = _load()
    if lib is None:
        from ..analysis.contours import find_contours_plain

        return find_contours_plain(mask)
    m = np.ascontiguousarray(mask)
    if m.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D mask, got shape {m.shape}")
    m = np.ascontiguousarray(m != 0, dtype=np.uint8)
    h, w = m.shape
    # a first guess (a walk passes a pixel at most a few times); the tracer
    # returns what it needed, and a second call gets that
    cap_points = cap_contours = 4 * int(np.count_nonzero(m)) + 1
    n_contours = ctypes.c_int64()
    while True:
        points = np.empty((cap_points, 2), np.int32)
        lengths = np.empty(cap_contours, np.int64)
        total = lib.find_contours_external(
            _u8ptr(m), h, w, points.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_points,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap_contours,
            ctypes.byref(n_contours),
        )
        if total <= cap_points and n_contours.value <= cap_contours:
            break
        cap_points, cap_contours = max(cap_points, total), max(cap_contours, n_contours.value)
    lengths = lengths[: n_contours.value]
    # the tracer lists the borders in scan order, OpenCV last found first
    return [points[s - n : s].copy() for s, n in zip(np.cumsum(lengths), lengths)][::-1]
