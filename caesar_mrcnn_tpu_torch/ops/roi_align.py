"""Multilevel ROIAlign over P2..P5: the CUDA kernel and its plain version.

Port of ``caesar_mrcnn_tpu/ops/roi_align.py::multilevel_roi_align_batched``
(``:114-193``), which the Pallas kernels of ``ops/roi_align_pallas.py``
also compute:

* each box's level comes from the exact FPN area rule (:func:`roi_levels`);
* samples sit at crop_and_resize positions with aligned corners,
  ``(lo + (hi - lo) * t) * (H - 1)`` with ``jnp.linspace``'s ``t``;
* each sample is a 4-tap bilinear read; samples outside the map read 0.

Feature maps are NHWC ``[B, H, W, C]`` (a ``permute(0, 2, 3, 1)`` of a
channels_last NCHW tensor, which needs no copy). :func:`roi_align` runs
``csrc/roi_align.cu`` for CUDA tensors and :func:`roi_align_plain` for CPU
tensors; both sum the four taps in f32 and round once to the feature dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _kernels


def roi_levels(boxes: torch.Tensor, image_area: float, num_levels: int = 4) -> torch.Tensor:
    """FPN level per box, 0-based over P2..P5 (JAX ``roi_levels``)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    # f32 like the JAX expression; a host scalar, so nothing is copied
    denom = float(224.0 / torch.sqrt(torch.tensor(image_area, dtype=torch.float32)))
    scale = torch.sqrt(torch.clamp_min(h * w, 1e-12)) / denom
    lvl = 4.0 + torch.round(torch.log2(scale))
    return torch.clamp(lvl, 2, 2 + num_levels - 1).to(torch.int32) - 2


def _sample_coords(lo: torch.Tensor, hi: torch.Tensor, extent_m1: torch.Tensor, n: int):
    """[..., n] sample positions; the last lands exactly on ``hi``.

    ``t`` is ``jnp.linspace``'s: ``i * f32(1 / (n - 1))``, last entry 1."""
    if n > 1:
        step = float(torch.tensor(1.0) / (n - 1))  # rounded to f32
        t = torch.arange(n, dtype=torch.float32, device=lo.device) * step
        t[-1] = 1.0
        return (lo[..., None] + (hi - lo)[..., None] * t) * extent_m1[..., None]
    return (0.5 * (lo + hi) * extent_m1)[..., None]


def roi_align_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    pool: int,
) -> torch.Tensor:
    """Plain PyTorch multilevel ROIAlign (any device): [B, N, pool, pool, C]."""
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    dev = boxes.device
    shapes = torch.tensor([f.shape[1:3] for f in features], dtype=torch.int64)
    sizes = shapes[:, 0] * shapes[:, 1]
    level_off = torch.cat([torch.zeros(1, dtype=torch.int64), sizes.cumsum(0)])
    per_img = int(level_off[-1])
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(b * per_img, c)
    flat = torch.cat([flat, flat.new_zeros(1, c)])
    zero_row = flat.shape[0] - 1

    levels = roi_levels(boxes, float(image_shape[0] * image_shape[1]), len(features)).long()
    lvl_h = shapes[:, 0].to(dev, torch.float32)[levels]  # [B, N]
    lvl_w = shapes[:, 1].to(dev, torch.float32)[levels]
    base = level_off[:-1].to(dev)[levels] + (torch.arange(b, device=dev) * per_img)[:, None]

    def axis(lo, hi, extent):
        pos = _sample_coords(lo, hi, extent - 1.0, pool)  # [B, N, P]
        em1 = (extent - 1.0)[..., None]
        inside = (pos >= 0) & (pos <= em1)
        t0 = torch.minimum(torch.floor(pos).clamp_min(0.0), em1)
        t1 = torch.minimum((t0 + 1.0).clamp_min(0.0), em1)
        frac = torch.minimum(pos.clamp_min(0.0), em1) - t0
        return inside, t0.long(), t1.long(), frac

    in_y, y0, y1, wy = axis(boxes[..., 0], boxes[..., 2], lvl_h)
    in_x, x0, x1, wx = axis(boxes[..., 1], boxes[..., 3], lvl_w)
    ok = in_y[..., :, None] & in_x[..., None, :]  # [B, N, P, P]
    wi = lvl_w.long()[..., None, None]

    def tap(yi, xi):
        idx = base[..., None, None] + yi[..., :, None] * wi + xi[..., None, :]
        idx = torch.where(ok, idx, torch.full_like(idx, zero_row))
        return flat[idx.reshape(-1)].reshape(b, n, pool, pool, c).float()

    wy, wx = wy[..., :, None], wx[..., None, :]
    w00 = ((1 - wy) * (1 - wx))[..., None]
    w01 = ((1 - wy) * wx)[..., None]
    w10 = (wy * (1 - wx))[..., None]
    w11 = (wy * wx)[..., None]
    out = tap(y0, x0) * w00 + tap(y0, x1) * w01 + tap(y1, x0) * w10 + tap(y1, x1) * w11
    return out.to(dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _roi_align_cuda(features, boxes, image_shape, pool):
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    if len(features) != 4:
        raise ValueError("roi_align kernel takes exactly 4 levels (P2..P5)")
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16, got {dtype}")
    if c % 2 or not 2 <= pool <= 32:
        raise ValueError(f"roi_align kernel needs even C and 2 <= pool <= 32 (C={c}, pool={pool})")
    for f in features:
        if not f.is_contiguous():
            raise ValueError("roi_align kernel needs contiguous NHWC levels")
        if f.data_ptr() % 8:
            raise ValueError("roi_align kernel needs 8-byte aligned levels")
    levels = roi_levels(boxes, float(image_shape[0] * image_shape[1]), 4).contiguous()
    out = torch.empty((b, n, pool, pool, c), dtype=dtype, device=boxes.device)
    hw = [int(d) for f in features for d in f.shape[1:3]]
    lib = _kernels.library()
    status = lib.caesar_roi_align(
        *(f.data_ptr() for f in features), *hw, b, c, boxes.data_ptr(),
        levels.data_ptr(), n, pool, _DTYPES[dtype], out.data_ptr(),
        torch.cuda.current_stream(boxes.device).cuda_stream,
    )
    _kernels.check(status, "caesar_roi_align")
    roi_align.launches += 1
    return out


def roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    pool: int,
) -> torch.Tensor:
    """Batched multilevel ROIAlign.

    Args:
      features: P2..P5 as NHWC [B, H_l, W_l, C], one dtype.
      boxes: [B, N, 4] float32 normalized (y1, x1, y2, x2).
      image_shape: (H, W) of the network input, for the level rule.
      pool: output size.

    Returns [B, N, pool, pool, C] in the feature dtype. CUDA tensors run the
    kernel (and count one launch in ``roi_align.launches``); CPU tensors run
    the plain version.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32 [B, N, 4], got {boxes.dtype} {tuple(boxes.shape)}")
    b, c = boxes.shape[0], features[0].shape[-1]
    for f in features:
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level {tuple(f.shape)} does not match [B={b}, H, W, C={c}]")
        if f.device != boxes.device or f.dtype != features[0].dtype:
            raise ValueError("levels and boxes must share one device; levels one dtype")
    if boxes.device.type == "cpu":
        return roi_align_plain(features, boxes, image_shape, pool)
    if boxes.device.type != "cuda":
        raise RuntimeError(f"roi_align: no kernel for device {boxes.device}")
    return _roi_align_cuda(features, boxes.contiguous(), image_shape, pool)


roi_align.launches = 0
