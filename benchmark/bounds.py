"""The yardstick of the kernels' rooflines: published peaks of one NVIDIA
H100 SXM and the least time a kernel could take for its work.

Frozen copies of ``caesar_mrcnn_tpu_torch/kernel_bench.py``'s bound
functions (``_bound``, ``nms_pairs``, ``nms_bound``, ``roi_align_pixels``,
``crop_sectors``, ``roi_align_bound``, ``roi_align_backward_bound``,
``crop_and_resize_bound``) and of the sampling rule they count with
(``ops/roi_align.py``'s ``roi_levels`` and ``_sample_coords``), so that a
change to the program cannot move the benchmark's yardstick. The bf16
dense peak, which ``mfu`` needs, is added.

A bound is the larger of the bytes the call must move (each input read
once, each output written once) over the memory rate and the operations
over the f32 rate outside the tensor cores. Where the work depends on the
data, the count is this data's: the IoU tests greedy NMS needs, the level
pixels the ROIAlign forward's taps touch, the 32-byte mask sectors the
crop's taps touch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_INT8_PER_S = 1979e12
# f32 operations of one IoU test (4 min/max, 2 sub, 2 max, 1 mul for the
# intersection; 2 x (2 sub, 1 mul) for the areas; add, sub; div; compare)
NMS_OPS_PER_PAIR = 20


def _bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations", whichever bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_levels(boxes: torch.Tensor, image_area: float, num_levels: int = 4) -> torch.Tensor:
    """FPN level per box, 0-based over P2..P5: ``4 + round(log2(sqrt(h w) /
    (224 / sqrt(image area))))`` clamped to P2..P5, in f32."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    denom = float(224.0 / torch.sqrt(torch.tensor(image_area, dtype=torch.float32)))
    scale = torch.sqrt(torch.clamp_min(h * w, 1e-12)) / denom
    lvl = 4.0 + torch.round(torch.log2(scale))
    return torch.clamp(lvl, 2, 2 + num_levels - 1).to(torch.int32) - 2


def _sample_coords(lo: torch.Tensor, hi: torch.Tensor, extent_m1: torch.Tensor, n: int):
    """[..., n] sample positions with aligned corners; the last lands on ``hi``."""
    if n > 1:
        step = float(torch.tensor(1.0) / (n - 1))
        t = torch.arange(n, dtype=torch.float32, device=lo.device) * step
        t[-1] = 1.0
        return (lo[..., None] + (hi - lo)[..., None] * t) * extent_m1[..., None]
    return (0.5 * (lo + hi) * extent_m1)[..., None]


def nms_pairs(scores, idx, valid, max_output: int) -> int:
    """The IoU tests greedy NMS needs on this data: each kept box against
    every later box up to the position at which the walk stops (the
    ``max_output``-th kept box, or the last box)."""
    b, n = scores.shape
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=order.device).expand(b, n))
    pos = torch.gather(rank, 1, idx.long())
    full = valid.sum(1) >= max_output
    stop = torch.where(full, pos.masked_fill(~valid, -1).amax(1) + 1, torch.full_like(pos[:, 0], n))
    return int(((stop[:, None] - 1 - pos) * valid).sum())


def nms_bound(b: int, n: int, max_output: int, pairs: int) -> Tuple[float, str]:
    """Boxes and scores read, indices and flags written; ``pairs`` IoU tests."""
    return _bound(b * n * 20 + b * max_output * 5, pairs * NMS_OPS_PER_PAIR)


def _axis_taps(lo, hi, extent, n: int):
    """Along one axis: whether each of the n samples lies inside the map,
    and its two taps, [..., n] each."""
    em1 = torch.as_tensor(extent, dtype=torch.float32, device=lo.device).expand_as(lo) - 1.0
    pos = _sample_coords(lo, hi, em1, n)
    em1 = em1[..., None]
    t0 = torch.minimum(torch.floor(pos).clamp_min(0.0), em1)
    t1 = torch.minimum(t0 + 1.0, em1)
    return (pos >= 0) & (pos <= em1), t0.long(), t1.long()


def _corner_taps(boxes, extent_y, extent_x, ph: int, pw: int):
    """The four taps (y, x) of every sample [..., ph, pw], and which
    samples lie inside the map."""
    iny, y0, y1 = _axis_taps(boxes[..., 0], boxes[..., 2], extent_y, ph)
    inx, x0, x1 = _axis_taps(boxes[..., 1], boxes[..., 3], extent_x, pw)
    taps = [(y[..., :, None], x[..., None, :]) for y in (y0, y1) for x in (x0, x1)]
    return taps, iny[..., :, None] & inx[..., None, :]


def roi_align_pixels(boxes, level_shapes: Sequence[Tuple[int, int]], image_shape: Tuple[int, int],
                     pool: int) -> int:
    """Distinct level pixels (image, level, y, x) that the taps of the
    boxes' samples read, each box on its FPN level."""
    b = boxes.shape[0]
    dev = boxes.device
    shapes = torch.tensor(level_shapes, dtype=torch.int64, device=dev)
    sizes = shapes[:, 0] * shapes[:, 1]
    level = roi_levels(boxes, float(image_shape[0] * image_shape[1]), len(level_shapes)).long()
    h, w = shapes[level, 0], shapes[level, 1]
    base = (sizes.cumsum(0) - sizes)[level] + torch.arange(b, device=dev)[:, None] * int(sizes.sum())
    taps, inside = _corner_taps(boxes, h.float(), w.float(), pool, pool)
    base, w = base[..., None, None], w[..., None, None]
    return int(torch.unique(torch.cat([(base + y * w + x)[inside] for y, x in taps])).numel())


def crop_sectors(mask_shape: Sequence[int], boxes, assign, crop_size: Tuple[int, int]) -> int:
    """Distinct 32-byte sectors of the f32 masks [B, H, W, G] that the taps
    of the crop's samples read from each box's assigned channel."""
    b, h, w, g = mask_shape
    taps, inside = _corner_taps(boxes, float(h), float(w), *crop_size)
    img = torch.arange(b, device=boxes.device)[:, None, None, None]
    ch = assign.long()[:, :, None, None]
    elems = torch.cat([(((img * h + y) * w + x) * g + ch)[inside] for y, x in taps])
    return int(torch.unique(elems // 8).numel())


def roi_align_bound(boxes, level_shapes: Sequence[Tuple[int, int]], image_shape: Tuple[int, int], pool: int,
                    c: int, itemsize: int) -> Tuple[float, str]:
    """The level pixels the taps touch and the boxes read, [B, N, pool,
    pool, C] written; 4 products and 3 sums per output element, plus the 3
    weight products."""
    b, n = boxes.shape[:2]
    outputs = b * n * pool * pool * c
    pixels = roi_align_pixels(boxes, level_shapes, image_shape, pool)
    return _bound((pixels * c + outputs) * itemsize + b * n * 16, outputs * 10)


def roi_align_backward_bound(b: int, level_shapes: Sequence[Tuple[int, int]], n: int, pool: int, c: int,
                             itemsize: int) -> Tuple[float, str]:
    """grad_out and boxes read, the level gradients written in the dtype;
    4 products and 4 sums per grad_out element."""
    grads = b * n * pool * pool * c
    levels = b * sum(h * w for h, w in level_shapes) * c
    return _bound((grads + levels) * itemsize + b * n * 16, grads * 8)


def crop_and_resize_bound(mask_shape: Sequence[int], boxes, assign, crop_size: Tuple[int, int]) -> Tuple[float, str]:
    """The mask sectors the taps touch, boxes and assignment read, f32
    crops written; 3 lerps per sample."""
    b, r = assign.shape
    samples = b * r * crop_size[0] * crop_size[1]
    nbytes = crop_sectors(mask_shape, boxes, assign, crop_size) * 32 + b * r * (16 + assign.element_size())
    return _bound(nbytes + samples * 4, samples * 12)
