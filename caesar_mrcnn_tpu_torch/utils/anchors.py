"""Anchor pyramid generation (host-side, cached; fed to the model as a
constant).

The port's copy of ``caesar_mrcnn_tpu/utils/anchors.py``, unchanged in behaviour
(the port imports nothing of the JAX package).

Semantics match the reference formulas exactly
(reference: mrcnn/utils.py:652-708, mrcnn/model.py:2764-2784): per level,
anchors are the meshgrid of (scale, ratio) boxes centred at feature-map cell
origins multiplied by the feature stride, in ``(y1, x1, y2, x2)`` order with
heights ``scale/sqrt(ratio)`` and widths ``scale*sqrt(ratio)``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

from ..config import Config


def generate_anchors(
    scales, ratios, shape: Sequence[int], feature_stride: int, anchor_stride: int
) -> np.ndarray:
    """Anchors for one pyramid level -> [N, (y1, x1, y2, x2)] float64 pixels."""
    scales, ratios = np.meshgrid(np.array(scales), np.array(ratios))
    scales = scales.flatten()
    ratios = ratios.flatten()

    heights = scales / np.sqrt(ratios)
    widths = scales * np.sqrt(ratios)

    shifts_y = np.arange(0, shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, shape[1], anchor_stride) * feature_stride
    shifts_x, shifts_y = np.meshgrid(shifts_x, shifts_y)

    box_widths, box_centers_x = np.meshgrid(widths, shifts_x)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y)

    box_centers = np.stack([box_centers_y, box_centers_x], axis=2).reshape([-1, 2])
    box_sizes = np.stack([box_heights, box_widths], axis=2).reshape([-1, 2])

    return np.concatenate(
        [box_centers - 0.5 * box_sizes, box_centers + 0.5 * box_sizes], axis=1
    )


def generate_pyramid_anchors(
    scales, ratios, feature_shapes, feature_strides, anchor_stride
) -> np.ndarray:
    """Concatenate per-level anchors, scale[0] level first
    (reference: mrcnn/utils.py:691-708)."""
    anchors = [
        generate_anchors(scales[i], ratios, feature_shapes[i], feature_strides[i], anchor_stride)
        for i in range(len(scales))
    ]
    return np.concatenate(anchors, axis=0)


@functools.lru_cache(maxsize=8)
def _cached_anchors(key: Tuple) -> np.ndarray:
    (scales, ratios, shapes, strides, astride, img_h, img_w) = key
    anchors = generate_pyramid_anchors(
        scales, ratios, np.array(shapes), strides, astride
    )
    # Normalize once; the graph consumes normalized anchors
    # (reference: mrcnn/model.py:2776-2783).
    scale = np.array([img_h - 1, img_w - 1, img_h - 1, img_w - 1])
    shift = np.array([0, 0, 1, 1])
    return ((anchors - shift) / scale).astype(np.float32)


def get_anchors(config: Config, image_shape=None) -> np.ndarray:
    """Normalized pyramid anchors for an image shape, cached per shape."""
    if image_shape is None:
        image_shape = config.image_shape
    h, w = int(image_shape[0]), int(image_shape[1])
    shapes = tuple(
        (int(np.ceil(h / s)), int(np.ceil(w / s))) for s in config.backbone_strides
    )
    key = (
        tuple(config.rpn_anchor_scales),
        tuple(config.rpn_anchor_ratios),
        shapes,
        tuple(config.backbone_strides),
        config.rpn_anchor_stride,
        h,
        w,
    )
    return _cached_anchors(key)
