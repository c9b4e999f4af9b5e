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


def overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N1, N2] of [..., N1, 4] and [..., N2, 4]
    (``overlaps_jax``, batched); zero-area pairs give 0."""
    y1 = torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    x1 = torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    y2 = torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
    x2 = torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
    inter = (y2 - y1).clamp_min(0.0) * (x2 - x1).clamp_min(0.0)
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), torch.zeros_like(union))


def box_refinement(box: torch.Tensor, gt_box: torch.Tensor) -> torch.Tensor:
    """Deltas turning ``box`` into ``gt_box`` (``box_refinement_jax``):
    heights and widths are floored at 1e-8 so padded boxes give no NaN."""
    h = (box[..., 2] - box[..., 0]).clamp_min(1e-8)
    w = (box[..., 3] - box[..., 1]).clamp_min(1e-8)
    gh = (gt_box[..., 2] - gt_box[..., 0]).clamp_min(1e-8)
    gw = (gt_box[..., 3] - gt_box[..., 1]).clamp_min(1e-8)
    dy = (gt_box[..., 0] + 0.5 * gh - (box[..., 0] + 0.5 * h)) / h
    dx = (gt_box[..., 1] + 0.5 * gw - (box[..., 1] + 0.5 * w)) / w
    return torch.stack([dy, dx, torch.log(gh / h), torch.log(gw / w)], dim=-1)


# ------------------------------------------------------------------- numpy


def extract_bboxes(mask: np.ndarray) -> np.ndarray:
    """Pixel boxes of a [H, W, N] mask stack -> [N, 4] int32; an empty mask
    gives a zero box (numpy, as ``utils/boxes.py::extract_bboxes``)."""
    n = mask.shape[-1]
    boxes = np.zeros([n, 4], dtype=np.int32)
    any_x = mask.any(axis=0)  # [W, N]
    any_y = mask.any(axis=1)  # [H, N]
    for i in range(n):
        xs = np.flatnonzero(any_x[:, i])
        ys = np.flatnonzero(any_y[:, i])
        if xs.size:
            boxes[i] = (ys[0], xs[0], ys[-1] + 1, xs[-1] + 1)
    return boxes


def compute_overlaps(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU [N1, N2] in f64 (numpy, as ``utils/boxes.py::compute_overlaps``)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    y1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    x1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    y2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    x2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    union = area1[:, None] + area2[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def box_refinement_np(box: np.ndarray, gt_box: np.ndarray) -> np.ndarray:
    """Deltas turning ``box`` into ``gt_box``, f32 (numpy, as
    ``utils/boxes.py::box_refinement``)."""
    box = box.astype(np.float32)
    gt_box = gt_box.astype(np.float32)
    h = box[:, 2] - box[:, 0]
    w = box[:, 3] - box[:, 1]
    gh = gt_box[:, 2] - gt_box[:, 0]
    gw = gt_box[:, 3] - gt_box[:, 1]
    dy = (gt_box[:, 0] + 0.5 * gh - (box[:, 0] + 0.5 * h)) / h
    dx = (gt_box[:, 1] + 0.5 * gw - (box[:, 1] + 0.5 * w)) / w
    return np.stack([dy, dx, np.log(gh / h), np.log(gw / w)], axis=1)


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


def compute_overlaps_masks(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Mask-IoU matrix of two [H, W, N] stacks (numpy, as
    ``utils/boxes.py::compute_overlaps_masks``)."""
    if masks1.shape[-1] == 0 or masks2.shape[-1] == 0:
        return np.zeros((masks1.shape[-1], masks2.shape[-1]))
    m1 = np.reshape(masks1 > 0.5, (-1, masks1.shape[-1])).astype(np.float32)
    m2 = np.reshape(masks2 > 0.5, (-1, masks2.shape[-1])).astype(np.float32)
    area1 = m1.sum(axis=0)
    area2 = m2.sum(axis=0)
    inter = m1.T @ m2
    union = area1[:, None] + area2[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def trim_zeros(x: np.ndarray) -> np.ndarray:
    """Drop all-zero rows (numpy, as ``utils/boxes.py::trim_zeros``)."""
    assert x.ndim == 2
    return x[~np.all(x == 0, axis=1)]
