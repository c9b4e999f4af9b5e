"""The paste of each tile's detection masks into its full frame: the CUDA
kernel and its plain version.

The tiled detect path's unmold on the card (``Detector.dispatch_tiles`` on
a CUDA device): a tile's padded detections [D, 6] and u8 masks [D, mh, mw]
become its ``[H, W, n]`` bool frame, ``n`` the kept detections, as
``Detector.unmold_detections`` makes it on the host for a full-frame tile
window (``utils/image.py::paste_mask`` a detection):

* the detections before the first zero class id, their pixel boxes
  ``utils/boxes.py::denorm_boxes`` on the tile, those of zero area dropped
  (:func:`kept_boxes`);
* each kept mask, ``u8 / 255`` in f32, resized bilinearly to its box,
  thresholded at 0.5, inside the box; 0 outside.

A frame is a flat bool tensor of ``H * W * D`` elements whose first
``H * W * n`` hold the ``[H, W, n]`` frame, C-contiguous; the rest is not
written. :func:`paste_masks` calls the operator ``caesar::paste_masks``
(``library.py``), which runs ``csrc/paste_masks.cu`` for CUDA detections
(frames on that device, or in pinned host memory, which the kernel writes
over PCIe) and :func:`paste_masks_plain` for CPU tensors; the plain version
is the tests' oracle, and nothing falls back to it on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import boxes as B
from ..utils import image as I
from . import library

TILES_PER_LAUNCH = 64  # the kernel takes its frames' addresses by value (csrc/paste_masks.cu kMaxTiles)


def kept_boxes(detections: np.ndarray, shape) -> Tuple[np.ndarray, np.ndarray]:
    """One tile's padded detections [D, 6] -> (the rows the unmold keeps,
    their pixel boxes [n, 4] int32 on a tile of ``shape`` (H, W))."""
    zero = np.flatnonzero(detections[:, 4] == 0)
    n = zero[0] if zero.size else detections.shape[0]
    boxes = B.denorm_boxes(detections[:n, :4], tuple(shape[:2]))
    rows = np.flatnonzero((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0)
    return rows, boxes[rows]


def paste_masks_plain(detections: torch.Tensor, masks: torch.Tensor, frames: Sequence[torch.Tensor],
                      shape) -> None:
    """The host unmold's paste into each tile's frame (CPU tensors)."""
    h, w = shape
    for det, m, frame in zip(detections.numpy(), masks.numpy(), frames):
        rows, boxes = kept_boxes(det, (h, w))
        full = frame.numpy()[: h * w * len(rows)].reshape(h, w, len(rows))
        full[...] = False
        small = m[rows].astype(np.float32) / 255.0
        for j in range(len(rows)):
            I.paste_mask(small[j], boxes[j], full[..., j])


def paste_masks(detections: torch.Tensor, masks: torch.Tensor, frames: Sequence[torch.Tensor], shape) -> None:
    """Paste every tile's kept masks into its frame.

    Args:
      detections: [B, D, 6] float32 (y1, x1, y2, x2 normalized, class id,
        score), padded with zero class ids.
      masks: [B, D, mh, mw] uint8, each detection's mask in its class.
      frames: B flat bool tensors of ``H * W * D`` elements, 16-byte
        aligned: on the detections' device, or, for CUDA detections, in
        pinned host memory.
      shape: the tile (H, W).

    CUDA tensors run the kernel (one launch per 64 tiles, counted in
    ``paste_masks.launches``), CPU tensors the plain version.
    """
    if (detections.dim() != 3 or detections.shape[-1] != 6 or masks.dim() != 4
            or masks.shape[:2] != detections.shape[:2]):
        raise ValueError(f"detections {tuple(detections.shape)} / masks {tuple(masks.shape)}")
    if detections.dtype != torch.float32 or masks.dtype != torch.uint8:
        raise TypeError("paste_masks takes float32 detections and uint8 masks")
    if detections.device != masks.device:
        raise ValueError("detections and masks on different devices")
    b, d = detections.shape[:2]
    if d > 1024:
        raise ValueError(f"paste_masks takes at most 1024 detections a tile, got {d}")
    if len(frames) != b:
        raise ValueError(f"{len(frames)} frames for {b} tiles")
    size = int(shape[0]) * int(shape[1]) * d
    for f in frames:
        if f.dtype != torch.bool or f.dim() != 1 or f.numel() != size or f.data_ptr() % 16:
            raise ValueError(f"a frame is a 16-byte aligned flat bool tensor of {size} elements")
        if f.device != detections.device and not (detections.is_cuda and f.device.type == "cpu" and f.is_pinned()):
            raise ValueError("frames lie on the detections' device or, for CUDA detections, in pinned memory")
    if b:
        library.ops.paste_masks(detections.contiguous(), masks.contiguous(), list(frames),
                                [int(shape[0]), int(shape[1])])


paste_masks.launches = 0
