"""Multilevel ROIAlign over P2..P5: the CUDA kernel and its plain version.

Port of ``caesar_mrcnn_tpu/ops/roi_align.py::multilevel_roi_align_batched``
(``:114-193``), which the Pallas kernels of ``ops/roi_align_pallas.py``
also compute:

* each box's level comes from the exact FPN area rule (:func:`roi_levels`);
* samples sit at crop_and_resize positions with aligned corners,
  ``(lo + (hi - lo) * t) * (H - 1)`` with ``jnp.linspace``'s ``t``;
* each sample is a 4-tap bilinear read; samples outside the map read 0.

Feature maps are NHWC ``[B, H, W, C]`` (a ``permute(0, 2, 3, 1)`` of a
channels_last NCHW tensor, which needs no copy). Each wrapper here checks
its inputs and calls an operator of the ``caesar`` namespace
(``library.py``), which runs the kernel for CUDA tensors and the plain
version for CPU tensors. :func:`roi_align` (``caesar::roi_align``:
``csrc/roi_align.cu`` or :func:`roi_align_plain`) sums the four taps in f32
and rounds once to the feature dtype. Its gradient in the levels,
:func:`roi_align_backward` (``caesar::roi_align_backward``), is the second
kernel of ``csrc/roi_align.cu`` (plain version:
:func:`roi_align_backward_plain`, the taps' weighted sums in f32).
:func:`crop_and_resize` (``caesar::crop_and_resize``), the mask-target crop
of training, samples the same way on one GT mask channel per box
(``csrc/crop_and_resize.cu``).

On the card each call is one kernel launch and nothing else: both ROIAlign
kernels find each box's level themselves (``sampling.cuh::fpn_level``, the
rule of :func:`roi_levels` as PyTorch evaluates it on the card), the
forward's lane vector follows C and the levels' alignment, and the crop
reads its int32 or int64 assignment as it is. All three are bound by
memory; the kernels' source notes say what holds each there, and
``kernel_bench.py`` splits and times each call against its bound, counted
from the bytes the data's taps touch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import library


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


def _taps(level_shapes: Sequence[Tuple[int, int]], boxes: torch.Tensor, image_shape: Tuple[int, int], pool: int):
    """The four bilinear taps of every sample: ([(row, weight)] * 4, rows),
    each row [B, N, pool, pool] an index into the levels flattened to
    ``[B * sum(H_l W_l) + 1, C]`` (image by image, P2 first; samples outside
    the map read the last, a zero row, ``rows``), each weight [B, N, pool,
    pool, 1] f32."""
    b = boxes.shape[0]
    dev = boxes.device
    shapes = torch.tensor([tuple(s) for s in level_shapes], dtype=torch.int64)
    sizes = shapes[:, 0] * shapes[:, 1]
    level_off = torch.cat([torch.zeros(1, dtype=torch.int64), sizes.cumsum(0)])
    per_img = int(level_off[-1])
    zero_row = b * per_img

    levels = roi_levels(boxes, float(image_shape[0] * image_shape[1]), len(level_shapes)).long()
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

    def row(yi, xi):
        idx = base[..., None, None] + yi[..., :, None] * wi + xi[..., None, :]
        return torch.where(ok, idx, torch.full_like(idx, zero_row))

    wy, wx = wy[..., :, None], wx[..., None, :]
    taps = [(row(y0, x0), (1 - wy) * (1 - wx)), (row(y0, x1), (1 - wy) * wx),
            (row(y1, x0), wy * (1 - wx)), (row(y1, x1), wy * wx)]
    return [(r, w[..., None]) for r, w in taps], zero_row


def roi_align_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    pool: int,
) -> torch.Tensor:
    """Plain PyTorch multilevel ROIAlign (any device): [B, N, pool, pool, C].
    Sums the four taps in f32 (f64 for f64 levels) and rounds once;
    differentiable in the levels."""
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    taps, _ = _taps([f.shape[1:3] for f in features], boxes, image_shape, pool)
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(-1, c)
    flat = torch.cat([flat, flat.new_zeros(1, c)])
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    out = None
    for idx, w in taps:
        term = flat[idx.reshape(-1)].reshape(b, n, pool, pool, c).to(acc) * w
        out = term if out is None else out + term
    return out.to(dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_shapes(name, dtype, c, pool, n_levels):
    if n_levels != 4:
        raise ValueError(f"{name} kernel takes exactly 4 levels (P2..P5)")
    if dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dtype}")
    if c % 2 or not 2 <= pool <= 32:
        raise ValueError(f"{name} kernel needs even C and 2 <= pool <= 32 (C={c}, pool={pool})")


def _level_inv_denom(image_shape: Tuple[int, int]) -> float:
    """The kernels' scale of the level rule: f32(1 / denom) with
    :func:`roi_levels`' f32 ``denom``. On the card, PyTorch divides a tensor
    by a host scalar as a product with the scalar's f32 reciprocal, and the
    kernels (``sampling.cuh::fpn_level``) do the same."""
    denom = np.float32(224.0) / np.sqrt(np.float32(image_shape[0] * image_shape[1]))
    return float(np.float32(1.0) / denom)


def _vector_bytes(features, c: int, itemsize: int) -> int:
    """The widest lane vector of the forward kernel (16, 8 or 4 bytes, at
    least two channels) that a row of C channels and every level's address
    allow."""
    for nbytes in (16, 8, 4):
        if nbytes >= 2 * itemsize and (c * itemsize) % nbytes == 0 and all(
                f.data_ptr() % nbytes == 0 for f in features):
            return nbytes
    raise ValueError(f"roi_align kernel needs levels aligned to {2 * itemsize} bytes")


def roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    pool: int,
) -> torch.Tensor:
    """Batched multilevel ROIAlign, differentiable in the levels.

    Args:
      features: P2..P5 as NHWC [B, H_l, W_l, C], one dtype.
      boxes: [B, N, 4] float32 normalized (y1, x1, y2, x2).
      image_shape: (H, W) of the network input, for the level rule.
      pool: output size.

    Returns [B, N, pool, pool, C] in the feature dtype, from
    ``caesar::roi_align``: CUDA tensors run the kernel alone (one launch,
    counted in ``roi_align.launches``: it finds each box's level itself),
    CPU tensors the plain version. Its gradient in the levels is
    ``caesar::roi_align_backward`` (:func:`roi_align_backward`); the boxes
    get none.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32 [B, N, 4], got {boxes.dtype} {tuple(boxes.shape)}")
    b, c = boxes.shape[0], features[0].shape[-1]
    for f in features:
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level {tuple(f.shape)} does not match [B={b}, H, W, C={c}]")
        if f.device != boxes.device or f.dtype != features[0].dtype:
            raise ValueError("levels and boxes must share one device; levels one dtype")
        if not f.is_contiguous():
            raise ValueError("roi_align takes contiguous NHWC levels")
    return library.ops.roi_align(list(features), boxes.detach(), [int(v) for v in image_shape], pool)


roi_align.launches = 0


# ------------------------------------------------------------------ backward


def roi_align_backward_plain(
    grad_out: torch.Tensor,
    boxes: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    image_shape: Tuple[int, int],
) -> List[torch.Tensor]:
    """Gradient of :func:`roi_align_plain` in the levels (any device): one
    [B, H_l, W_l, C] tensor per level, in grad_out's dtype. Each tap's
    ``grad * weight`` summed into its level pixel in f32 (f64 at f64, where
    it is the exact sum) and rounded once, as the kernel does."""
    b, n, pool, _, c = grad_out.shape
    taps, zero_row = _taps(level_shapes, boxes, image_shape, pool)
    acc = torch.float64 if grad_out.dtype == torch.float64 else torch.float32
    g = grad_out.to(acc)
    total = torch.zeros(zero_row + 1, c, dtype=acc, device=grad_out.device)
    for idx, w in taps:
        total.index_add_(0, idx.reshape(-1), (g * w).reshape(-1, c))
    per_img = total[:zero_row].view(b, -1, c)
    sizes = [int(h) * int(w) for h, w in level_shapes]
    return [lvl.reshape(b, int(h), int(w), c).to(grad_out.dtype)
            for lvl, (h, w) in zip(per_img.split(sizes, dim=1), level_shapes)]


def roi_align_backward(
    grad_out: torch.Tensor,
    boxes: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    image_shape: Tuple[int, int],
) -> List[torch.Tensor]:
    """Gradient of :func:`roi_align` in the levels.

    Args:
      grad_out: [B, N, pool, pool, C], the levels' dtype.
      boxes: [B, N, 4] float32, the forward's boxes.
      level_shapes: (H_l, W_l) of P2..P5.
      image_shape: (H, W) of the network input, for the level rule.

    Returns one [B, H_l, W_l, C] gradient per level, in grad_out's dtype:
    views of the one flat tensor of ``caesar::roi_align_backward``. CUDA
    tensors run the kernel (one launch, counted in
    ``roi_align_backward.launches``; none for zero boxes), which finds each
    box's level itself: f32 atomic sums rounded once to the dtype. CPU
    tensors run :func:`roi_align_backward_plain`.
    """
    if grad_out.dim() != 5 or grad_out.shape[2] != grad_out.shape[3]:
        raise ValueError(f"grad_out must be [B, N, pool, pool, C], got {tuple(grad_out.shape)}")
    if boxes.shape != grad_out.shape[:2] + (4,) or boxes.dtype != torch.float32:
        raise ValueError(f"boxes {boxes.dtype} {tuple(boxes.shape)} do not match grad_out")
    if boxes.device != grad_out.device:
        raise ValueError("grad_out and boxes must share one device")
    b, c = grad_out.shape[0], grad_out.shape[-1]
    shapes = [(int(h), int(w)) for h, w in level_shapes]
    flat = library.ops.roi_align_backward(grad_out, boxes, [d for s in shapes for d in s],
                                          [int(v) for v in image_shape])
    return [g.view(b, h, w, c) for g, (h, w) in zip(flat.split([b * h * w * c for h, w in shapes]), shapes)]


roi_align_backward.launches = 0


# ----------------------------------------------------------- crop_and_resize


def crop_and_resize_plain(
    masks: torch.Tensor, boxes: torch.Tensor, assign: torch.Tensor, crop_size: Tuple[int, int]
) -> torch.Tensor:
    """Plain PyTorch crop of mask channel ``assign[b, r]`` at ``boxes[b, r]``
    (any device): [B, R, ph, pw] f32, in the JAX bilinear order."""
    b, h, w, _ = masks.shape
    ph, pw = crop_size

    def axis(lo, hi, extent, n):
        em1 = float(extent - 1)
        pos = _sample_coords(lo, hi, torch.full_like(lo, em1), n)  # [B, R, n]
        t0 = torch.floor(pos).clamp(0.0, em1)
        t1 = (t0 + 1.0).clamp(0.0, em1)
        frac = pos.clamp(0.0, em1) - t0
        return (pos >= 0) & (pos <= em1), t0.long(), t1.long(), frac

    in_y, y0, y1, wy = axis(boxes[..., 0], boxes[..., 2], h, ph)
    in_x, x0, x1, wx = axis(boxes[..., 1], boxes[..., 3], w, pw)
    bi = torch.arange(b, device=masks.device)[:, None, None, None]
    ch = assign.long()[:, :, None, None]

    def tap(yi, xi):
        return masks[bi, yi[..., :, None], xi[..., None, :], ch]

    wx, wy = wx[..., None, :], wy[..., :, None]
    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(in_y[..., :, None] & in_x[..., None, :], out, torch.zeros_like(out))


def crop_and_resize(
    masks: torch.Tensor, boxes: torch.Tensor, assign: torch.Tensor, crop_size: Tuple[int, int]
) -> torch.Tensor:
    """Bilinear crop-and-resize of one mask channel per box, batched: port
    of ``caesar_mrcnn_tpu/ops/roi_align.py::crop_and_resize`` at its
    training call site (``models/targets.py:237-257``), where each ROI crops
    its assigned GT mask.

    Args:
      masks: [B, H, W, G] float32 GT masks.
      boxes: [B, R, 4] float32 normalized (y1, x1, y2, x2).
      assign: [B, R] integer channel of each box, in 0..G-1 (int32 or
        int64 on the card).
      crop_size: (ph, pw), each at least 2.

    Returns [B, R, ph, pw] float32; samples outside the map read 0, from
    ``caesar::crop_and_resize``: CUDA tensors run
    ``csrc/crop_and_resize.cu`` alone (one launch, counted in
    ``crop_and_resize.launches``), which reads each distinct tap of the
    assigned channel once per box, in place; a block's shared memory, 16 ph
    pw + 24 (ph + pw) + 4 (H + W) bytes, must fit 227 KB. CPU tensors run
    :func:`crop_and_resize_plain`.
    """
    if masks.dim() != 4 or masks.dtype != torch.float32:
        raise ValueError(f"masks must be float32 [B, H, W, G], got {masks.dtype} {tuple(masks.shape)}")
    b, r = assign.shape
    if boxes.shape != (b, r, 4) or boxes.dtype != torch.float32 or masks.shape[0] != b:
        raise ValueError(f"boxes {tuple(boxes.shape)} / assign {tuple(assign.shape)} / masks {tuple(masks.shape)}")
    if not (masks.device == boxes.device == assign.device):
        raise ValueError("masks, boxes and assign must share one device")
    ph, pw = (int(v) for v in crop_size)
    if ph < 2 or pw < 2:
        raise ValueError(f"crop_size must be at least 2x2, got {crop_size}")
    return library.ops.crop_and_resize(masks, boxes, assign, [ph, pw])


crop_and_resize.launches = 0
