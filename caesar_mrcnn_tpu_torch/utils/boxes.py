"""Box math: torch twins of the JAX device functions and numpy copies of the
host ones (``caesar_mrcnn_tpu/utils/boxes.py``, which imports jax).

Boxes are ``[..., (y1, x1, y2, x2)]``; in pixel coordinates ``(y2, x2)`` is
outside the box, in normalized coordinates it is inside.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# exp(dh/dw) clamp of the JAX code (utils/boxes.py:157-160): an untrained RPN
# can emit huge log-scale deltas, and the unguarded exp overflows to inf.
_MAX_DELTA_LOG = 4.135166556742356


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dy, dx, log dh, log dw) refinements (``apply_box_deltas_jax``)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h + deltas[..., 0] * h
    cx = boxes[..., 1] + 0.5 * w + deltas[..., 1] * w
    h = h * torch.exp(deltas[..., 2].clamp(-_MAX_DELTA_LOG, _MAX_DELTA_LOG))
    w = w * torch.exp(deltas[..., 3].clamp(-_MAX_DELTA_LOG, _MAX_DELTA_LOG))
    y1 = cy - 0.5 * h
    x1 = cx - 0.5 * w
    return torch.stack([y1, x1, y1 + h, x1 + w], dim=-1)


def clip_boxes(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Clip boxes to ``window`` (y1, x1, y2, x2) (``clip_boxes_jax``).

    ``window`` is [4], or [..., 4] broadcasting against ``boxes[..., 0]``.
    """
    wy1, wx1, wy2, wx2 = window.unbind(-1)
    y1 = torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2)
    x1 = torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2)
    y2 = torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2)
    x2 = torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def norm_boxes(boxes: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Pixel -> normalized coords (numpy, as ``utils/boxes.py::norm_boxes``)."""
    h, w = shape
    scale = np.array([h - 1, w - 1, h - 1, w - 1])
    shift = np.array([0, 0, 1, 1])
    return ((np.asarray(boxes) - shift) / scale).astype(np.float32)


def denorm_boxes(boxes: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Normalized -> pixel coords (numpy, as ``utils/boxes.py::denorm_boxes``)."""
    h, w = shape
    scale = np.array([h - 1, w - 1, h - 1, w - 1])
    shift = np.array([0, 0, 1, 1])
    return np.around(np.asarray(boxes) * scale + shift).astype(np.int32)
