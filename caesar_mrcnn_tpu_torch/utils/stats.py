"""Sigma-clipped statistics (astropy.stats.sigma_clipped_stats equivalent,
used by the reference for source flux background stats,
reference: mrcnn/sfinder.py:1051).

The port's copy of ``caesar_mrcnn_tpu/utils/stats.py``, unchanged in behaviour
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sigma_clipped_stats(
    data: np.ndarray, sigma: float = 3.0, maxiters: int = 5
) -> Tuple[float, float, float]:
    """(mean, median, stddev) after iterative sigma clipping about the
    median."""
    vals = np.asarray(data, dtype=np.float64).ravel()
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return float("nan"), float("nan"), float("nan")
    for _ in range(maxiters):
        med = np.median(vals)
        std = np.std(vals)
        if std == 0:
            break
        keep = np.abs(vals - med) <= sigma * std
        if keep.all():
            break
        vals = vals[keep]
        if vals.size == 0:
            return float("nan"), float("nan"), float("nan")
    return float(np.mean(vals)), float(np.median(vals)), float(np.std(vals))
