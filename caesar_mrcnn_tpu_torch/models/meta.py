"""Image meta vector codec, numpy only (``caesar_mrcnn_tpu/models/meta.py``
imports jax): ``[image_id(1), original_shape(3), image_shape(3), window(4),
scale(1), active_class_ids(num_classes)]``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def compose_image_meta(
    image_id, original_image_shape, image_shape, window, scale, active_class_ids
) -> np.ndarray:
    return np.array(
        [image_id]
        + list(original_image_shape)
        + list(image_shape)
        + list(window)
        + [scale]
        + list(active_class_ids),
        dtype=np.float32,
    )


def parse_image_meta(meta: np.ndarray) -> Dict[str, np.ndarray]:
    """Parse a batch of meta vectors, batch axis first."""
    meta = np.asarray(meta)
    return {
        "image_id": meta[:, 0].astype(np.int32),
        "original_image_shape": meta[:, 1:4].astype(np.int32),
        "image_shape": meta[:, 4:7].astype(np.int32),
        "window": meta[:, 7:11].astype(np.int32),
        "scale": meta[:, 11].astype(np.float32),
        "active_class_ids": meta[:, 12:].astype(np.int32),
    }
