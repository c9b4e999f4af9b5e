"""IRAF zscale interval + contrast/bias stretch.

The port's copy of ``caesar_mrcnn_tpu/utils/zscale.py``, unchanged in behaviour
(the port imports nothing of the JAX package).

Re-implementation of the display algorithms the reference obtains from
``astropy.visualization`` (``ZScaleInterval`` used at
reference: mrcnn/utils.py:1166-1172, ``ContrastBiasStretch`` at
reference: mrcnn/utils.py:1174-1180). astropy is not a dependency of this
framework; the algorithm below follows the published IRAF zscale procedure
(sampled sorted pixels, iterative k-sigma-clipped line fit through the
midpoint, slope divided by the contrast).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def zscale_limits(
    values: np.ndarray,
    contrast: float = 0.25,
    nsamples: int = 1000,
    max_reject: float = 0.5,
    min_npixels: int = 5,
    krej: float = 2.5,
    max_iterations: int = 5,
) -> Tuple[float, float]:
    """Compute (vmin, vmax) of the zscale interval of ``values``."""
    values = np.asarray(values, dtype=np.float64).ravel()
    values = values[np.isfinite(values)]
    if values.size == 0:
        return 0.0, 1.0

    stride = int(max(1.0, float(values.size) / nsamples))
    samples = np.sort(values[::stride][:nsamples])
    npix = samples.size
    if npix < 2:
        v = float(samples[0]) if npix else 0.0
        return v, v + 1.0

    vmin = float(samples[0])
    vmax = float(samples[-1])

    # Iterative sigma-clipped weighted linear fit to the sorted samples.
    minpix = max(min_npixels, int(npix * max_reject))
    x = np.arange(npix, dtype=np.float64)
    badpix = np.zeros(npix, dtype=bool)
    ngoodpix = npix
    last_ngoodpix = npix + 1
    ngrow = max(1, int(npix * 0.01))
    kernel = np.ones(ngrow)
    slope, intercept = 0.0, float(np.median(samples))

    for _ in range(max_iterations):
        if ngoodpix >= last_ngoodpix or ngoodpix < minpix:
            break
        w = (~badpix).astype(np.float64)
        sw = w.sum()
        mx = (w * x).sum() / sw
        my = (w * samples).sum() / sw
        cov = (w * (x - mx) * (samples - my)).sum()
        var = (w * (x - mx) ** 2).sum()
        slope = cov / var if var > 0 else 0.0
        intercept = my - slope * mx

        flat = samples - (slope * x + intercept)
        sigma = flat[~badpix].std()
        threshold = krej * sigma
        badpix |= np.abs(flat) > threshold
        # Grow the rejection mask so isolated survivors inside rejected
        # runs are also dropped (IRAF's "grow" step).
        badpix = np.convolve(badpix.astype(np.float64), kernel, mode="same") > 0
        last_ngoodpix = ngoodpix
        ngoodpix = int((~badpix).sum())

    if ngoodpix >= minpix:
        if contrast > 0:
            slope = slope / contrast
        # astropy/IRAF midpoint convention: (npix + 1) // 2
        center = (npix + 1) // 2
        median = float(np.median(samples))
        vmin = max(vmin, median - (center - 1) * slope)
        vmax = min(vmax, median + (npix - center) * slope)
    return float(vmin), float(vmax)


def zscale_stretch(data: np.ndarray, contrast: float = 0.25) -> np.ndarray:
    """Map ``data`` through the zscale interval into [0, 1] (clipped).

    Equivalent of ``ZScaleInterval(contrast)(data)``
    (reference: mrcnn/utils.py:1166-1172). Uses the native C++ limits
    kernel when libfastops is built.
    """
    try:
        from ..native import available, zscale_limits as native_limits

        if available():
            vmin, vmax = native_limits(data, contrast=contrast)
        else:
            vmin, vmax = zscale_limits(data, contrast=contrast)
    except ImportError:
        vmin, vmax = zscale_limits(data, contrast=contrast)
    if vmax <= vmin:
        return np.zeros_like(data, dtype=np.float32)
    out = (np.asarray(data, dtype=np.float32) - vmin) / (vmax - vmin)
    return np.clip(out, 0.0, 1.0)


def contrast_bias_stretch(
    data: np.ndarray, contrast: float = 1.0, bias: float = 0.5
) -> np.ndarray:
    """``clip((x - bias) * contrast + 0.5, 0, 1)`` — the astropy
    ``ContrastBiasStretch`` formula (reference: mrcnn/utils.py:1174-1180).

    Input is expected in [0, 1] (the reference applies it after zscale or on
    normalized data).
    """
    out = (np.asarray(data, dtype=np.float32) - bias) * contrast + 0.5
    return np.clip(out, 0.0, 1.0)
