"""Head-only training debug path: externally generated ROIs.

The port's copy of ``caesar_mrcnn_tpu/models/debug_rois.py``, unchanged in behaviour
(the port imports nothing of the JAX package).

Re-derivation of the reference's ``generate_random_rois`` + the
``USE_RPN_ROIS=False`` mode (reference: mrcnn/model.py:1647-1718,
1380-1533) used to train/debug classifier+mask heads on synthetic ROIs
instead of RPN proposals.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def generate_random_rois(
    image_shape,
    count: int,
    gt_boxes: np.ndarray,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random ROIs placed 90% around GT boxes, 10% anywhere
    (reference: mrcnn/model.py:1647-1718). Returns [count, 4] int32 pixel
    boxes (y1, x1, y2, x2)."""
    rng = rng or np.random.RandomState()
    h, w = image_shape[:2]
    rois = np.zeros((count, 4), dtype=np.int32)
    n_gt = gt_boxes.shape[0]
    rois_per_box = int(0.9 * count / max(n_gt, 1)) if n_gt else 0

    idx = 0
    for i in range(n_gt):
        gy1, gx1, gy2, gx2 = gt_boxes[i]
        gh = gy2 - gy1
        gw = gx2 - gx1
        # boxes of similar scale jittered around the GT
        for _ in range(rois_per_box):
            if idx >= count:
                break
            cy = rng.randint(max(0, gy1 - gh), min(h, gy2 + gh) + 1)
            cx = rng.randint(max(0, gx1 - gw), min(w, gx2 + gw) + 1)
            bh = max(2, int(abs(rng.normal(gh, gh * 0.35))))
            bw = max(2, int(abs(rng.normal(gw, gw * 0.35))))
            y1 = np.clip(cy - bh // 2, 0, h - 2)
            x1 = np.clip(cx - bw // 2, 0, w - 2)
            y2 = np.clip(y1 + bh, y1 + 1, h)
            x2 = np.clip(x1 + bw, x1 + 1, w)
            rois[idx] = (y1, x1, y2, x2)
            idx += 1

    # the remainder anywhere in the image
    while idx < count:
        y = np.sort(rng.randint(0, h, 2))
        x = np.sort(rng.randint(0, w, 2))
        if y[1] - y[0] >= 2 and x[1] - x[0] >= 2:
            rois[idx] = (y[0], x[0], y[1], x[1])
            idx += 1
    return rois
