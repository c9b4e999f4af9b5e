"""Host-side image geometry without cv2: resize, mold and mask unmold.

Ports of ``caesar_mrcnn_tpu/utils/image.py`` (which imports cv2) with
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False)``
in place of ``cv2.INTER_LINEAR``: both sample at half-pixel centres and
clamp at the border.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize(image: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of [H, W] or [H, W, C] to ``shape[:2]``, float32."""
    src = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))
    x = src[None, None] if src.dim() == 2 else src.permute(2, 0, 1)[None]
    out = F.interpolate(
        x, size=(int(shape[0]), int(shape[1])), mode="bilinear", align_corners=False
    )[0]
    return (out[0] if src.dim() == 2 else out.permute(1, 2, 0)).numpy()


def resize_image(
    image: np.ndarray,
    min_dim: Optional[int] = None,
    max_dim: Optional[int] = None,
    min_scale: Optional[float] = None,
    mode: str = "square",
):
    """Aspect-preserving resize + pad. Returns (image, window, scale,
    padding, crop) like the JAX package; modes none, square and pad64."""
    image_dtype = image.dtype
    h, w = image.shape[:2]
    window = (0, 0, h, w)
    scale = 1.0
    padding = [(0, 0), (0, 0), (0, 0)]

    if mode == "none":
        return image, window, scale, padding, None
    if mode not in ("square", "pad64"):
        raise ValueError(f"Mode {mode} not supported")

    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if min_scale and scale < min_scale:
        scale = min_scale
    if max_dim and mode == "square":
        image_max = max(h, w)
        if round(image_max * scale) > max_dim:
            scale = max_dim / image_max
    if scale != 1.0:
        image = resize(image, (round(h * scale), round(w * scale)))

    h, w = image.shape[:2]
    if mode == "square":
        top_pad = (max_dim - h) // 2
        bottom_pad = max_dim - h - top_pad
        left_pad = (max_dim - w) // 2
        right_pad = max_dim - w - left_pad
    else:
        if min_dim and min_dim % 64:
            raise ValueError("Minimum dimension must be a multiple of 64")
        pad_h = -h % 64
        pad_w = -w % 64
        top_pad, left_pad = pad_h // 2, pad_w // 2
        bottom_pad, right_pad = pad_h - top_pad, pad_w - left_pad
    padding = [(top_pad, bottom_pad), (left_pad, right_pad), (0, 0)]
    image = np.pad(image, padding[: image.ndim], mode="constant", constant_values=0)
    window = (top_pad, left_pad, h + top_pad, w + left_pad)
    return image.astype(image_dtype), window, scale, padding, None


def paste_mask(mask: np.ndarray, bbox, frame: np.ndarray) -> None:
    """Resize a small float mask to ``bbox`` (pixel y1, x1, y2, x2),
    threshold it at 0.5 and write it into the bool ``frame`` [H, W]."""
    y1, x1, y2, x2 = [int(v) for v in bbox]
    frame[y1:y2, x1:x2] = resize(mask, (y2 - y1, x2 - x1)) >= 0.5


def unmold_mask(mask: np.ndarray, bbox, image_shape) -> np.ndarray:
    """Paste a small float mask into a new full frame at ``bbox``."""
    full = np.zeros(tuple(image_shape[:2]), dtype=bool)
    paste_mask(mask, bbox, full)
    return full


def mold_image(images: np.ndarray, mean_pixel) -> np.ndarray:
    """Subtract the mean pixel, float32."""
    return images.astype(np.float32) - np.asarray(mean_pixel, dtype=np.float32)
