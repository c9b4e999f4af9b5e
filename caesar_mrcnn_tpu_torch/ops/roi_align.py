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
Its gradient in the levels, :func:`roi_align_backward`, is the second
kernel of ``csrc/roi_align.cu`` (plain version: autograd through
:func:`roi_align_plain`). :func:`crop_and_resize`, the mask-target crop of
training, samples the same way on one GT mask channel per box
(``csrc/crop_and_resize.cu``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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
    """Plain PyTorch multilevel ROIAlign (any device): [B, N, pool, pool, C].
    Sums in f32 (f64 for f64 levels); differentiable in the levels."""
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
    acc = torch.float64 if dtype == torch.float64 else torch.float32

    def tap(yi, xi):
        idx = base[..., None, None] + yi[..., :, None] * wi + xi[..., None, :]
        idx = torch.where(ok, idx, torch.full_like(idx, zero_row))
        return flat[idx.reshape(-1)].reshape(b, n, pool, pool, c).to(acc)

    wy, wx = wy[..., :, None], wx[..., None, :]
    w00 = ((1 - wy) * (1 - wx))[..., None]
    w01 = ((1 - wy) * wx)[..., None]
    w10 = (wy * (1 - wx))[..., None]
    w11 = (wy * wx)[..., None]
    out = tap(y0, x0) * w00 + tap(y0, x1) * w01 + tap(y1, x0) * w10 + tap(y1, x1) * w11
    return out.to(dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_shapes(name, dtype, c, pool, n_levels):
    if n_levels != 4:
        raise ValueError(f"{name} kernel takes exactly 4 levels (P2..P5)")
    if dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dtype}")
    if c % 2 or not 2 <= pool <= 32:
        raise ValueError(f"{name} kernel needs even C and 2 <= pool <= 32 (C={c}, pool={pool})")


def _roi_align_cuda(features, boxes, levels, pool):
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    _check_kernel_shapes("roi_align", dtype, c, pool, len(features))
    for f in features:
        if not f.is_contiguous():
            raise ValueError("roi_align kernel needs contiguous NHWC levels")
        if f.data_ptr() % 8:
            raise ValueError("roi_align kernel needs 8-byte aligned levels")
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


class _RoiAlignCuda(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; boxes
    carry no gradient (the training graph detaches its ROIs)."""

    @staticmethod
    def forward(ctx, boxes, image_shape, pool, *features):
        levels = roi_levels(boxes, float(image_shape[0] * image_shape[1]), 4).contiguous()
        ctx.save_for_backward(boxes)
        ctx.image_shape = image_shape
        ctx.level_shapes = [tuple(f.shape[1:3]) for f in features]
        return _roi_align_cuda(features, boxes, levels, pool)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        grads = roi_align_backward(grad.contiguous(), boxes, ctx.level_shapes, ctx.image_shape)
        return (None, None, None, *grads)


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

    Returns [B, N, pool, pool, C] in the feature dtype. CUDA tensors run the
    kernel (and count one launch in ``roi_align.launches``), and its
    gradient runs :func:`roi_align_backward`'s kernel; CPU tensors run the
    plain version and autograd through it.
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
    return _RoiAlignCuda.apply(boxes.detach().contiguous(), tuple(image_shape), pool, *features)


roi_align.launches = 0


# ------------------------------------------------------------------ backward


def roi_align_backward_plain(
    grad_out: torch.Tensor,
    boxes: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    image_shape: Tuple[int, int],
) -> List[torch.Tensor]:
    """Gradient of :func:`roi_align_plain` in the levels, by autograd
    (any device): one [B, H_l, W_l, C] tensor per level, in grad_out's
    dtype. At f64 it is the exact sum of ``grad * w_tap``."""
    b, _, pool, _, c = grad_out.shape
    feats = [
        torch.zeros((b, h, w, c), dtype=grad_out.dtype, device=grad_out.device, requires_grad=True)
        for h, w in level_shapes
    ]
    with torch.enable_grad():
        out = roi_align_plain(feats, boxes, image_shape, pool)
        return list(torch.autograd.grad(out, feats, grad_out))


def _roi_align_backward_cuda(grad_out, boxes, level_shapes, levels):
    b, n, pool, _, c = grad_out.shape
    dtype = grad_out.dtype
    _check_kernel_shapes("roi_align_backward", dtype, c, pool, len(level_shapes))
    if grad_out.data_ptr() % 16:
        raise ValueError("roi_align_backward kernel needs a 16-byte aligned grad_out")
    sizes = [b * h * w * c for h, w in level_shapes]
    scratch = torch.zeros(sum(sizes), dtype=torch.float32, device=grad_out.device)
    if n:  # no box, no gradient: nothing to launch
        hw = [int(d) for shape in level_shapes for d in shape]
        status = _kernels.library().caesar_roi_align_backward(
            *(g.data_ptr() for g in scratch.split(sizes)), *hw, b, c, boxes.data_ptr(),
            levels.data_ptr(), n, pool, _DTYPES[dtype], grad_out.data_ptr(),
            torch.cuda.current_stream(grad_out.device).cuda_stream,
        )
        _kernels.check(status, "caesar_roi_align_backward")
        roi_align_backward.launches += 1
    flat = scratch if dtype == torch.float32 else scratch.to(dtype)  # one cast for all levels
    return [g.view(b, h, w, c) for g, (h, w) in zip(flat.split(sizes), level_shapes)]


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

    Returns one [B, H_l, W_l, C] gradient per level, in grad_out's dtype.
    CUDA tensors run the kernel (one launch, counted in
    ``roi_align_backward.launches``; none for zero boxes): f32 atomic sums
    rounded once to the dtype. CPU tensors run
    :func:`roi_align_backward_plain`.
    """
    if grad_out.dim() != 5 or grad_out.shape[2] != grad_out.shape[3]:
        raise ValueError(f"grad_out must be [B, N, pool, pool, C], got {tuple(grad_out.shape)}")
    if boxes.shape != grad_out.shape[:2] + (4,) or boxes.dtype != torch.float32:
        raise ValueError(f"boxes {boxes.dtype} {tuple(boxes.shape)} do not match grad_out")
    if boxes.device != grad_out.device:
        raise ValueError("grad_out and boxes must share one device")
    if grad_out.device.type == "cpu":
        return roi_align_backward_plain(grad_out, boxes, level_shapes, image_shape)
    if grad_out.device.type != "cuda":
        raise RuntimeError(f"roi_align_backward: no kernel for device {grad_out.device}")
    boxes = boxes.contiguous()
    levels = roi_levels(boxes, float(image_shape[0] * image_shape[1]), len(level_shapes)).contiguous()
    return _roi_align_backward_cuda(grad_out.contiguous(), boxes, [tuple(s) for s in level_shapes], levels)


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
      assign: [B, R] integer channel of each box, in 0..G-1.
      crop_size: (ph, pw), each at least 2.

    Returns [B, R, ph, pw] float32; samples outside the map read 0. CUDA
    tensors run ``csrc/crop_and_resize.cu`` (one launch, counted in
    ``crop_and_resize.launches``), which reads the assigned channel in
    place; CPU tensors run :func:`crop_and_resize_plain`.
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
    if masks.device.type == "cpu":
        return crop_and_resize_plain(masks, boxes, assign, (ph, pw))
    if masks.device.type != "cuda":
        raise RuntimeError(f"crop_and_resize: no kernel for device {masks.device}")
    masks = masks.contiguous()
    boxes = boxes.contiguous()
    assign32 = assign.to(torch.int32).contiguous()
    out = torch.empty((b, r, ph, pw), dtype=torch.float32, device=masks.device)
    _, h, w, g = masks.shape
    status = _kernels.library().caesar_crop_and_resize(
        masks.data_ptr(), b, h, w, g, boxes.data_ptr(), assign32.data_ptr(), r, ph, pw,
        out.data_ptr(), torch.cuda.current_stream(masks.device).cuda_stream,
    )
    _kernels.check(status, "caesar_crop_and_resize")
    crop_and_resize.launches += 1
    return out


crop_and_resize.launches = 0
