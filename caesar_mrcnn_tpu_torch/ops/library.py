"""The ``caesar`` operator namespace: every hand-written kernel of
``csrc/`` as an operator of PyTorch's dispatcher.

Each operator has three implementations, registered apart:

* ``CUDA``: the kernel, called through the ``ctypes`` library of
  :mod:`._kernels` on the tensors' addresses and the current stream. Every
  choice that needs an address (the ROIAlign forward's lane vector, the
  int8 convolution's operand copies and its cached TMA weight maps, the
  split-K counters) is made here, at run time, and each launch is counted
  here on its public wrapper (``nms_padded.launches``, ``roi_align.launches``,
  ...);
* ``CPU``: the plain PyTorch version beside the wrapper, the tests'
  oracle;
* fake: shapes and dtypes only, for ``torch.export`` and the meta device.

No other device has an implementation, so the dispatcher refuses it, and
nothing falls back from the card to a plain version. An exported graph
holds ``caesar::*`` nodes, which run the kernels on the card. ``roi_align``
takes its gradient from ``roi_align_backward`` (``register_autograd``),
the kernel on the card and the plain gradient on the CPU.

The public wrappers (``nms.nms_padded``, ``roi_align.roi_align``,
``roi_align.roi_align_backward``, ``roi_align.crop_and_resize``,
``quant.conv2d_int8``, ``quant.quantize_int8``, ``paste.paste_masks``)
check shapes, dtypes and devices, then call :data:`ops`. The namespace is ``caesar`` for this
package; a copy of the port imported under another name (``kernel_bench
--parent``) registers its own, named after it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _kernels
from . import nms as N
from . import paste as P
from . import quant as Q
from . import roi_align as R

_ROOT = __name__.split(".")[0]
NAMESPACE = "caesar" if _ROOT == "caesar_mrcnn_tpu_torch" else _ROOT
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _register(schema: str, cpu, cuda, fake) -> None:
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------- nms


def _nms_cuda(boxes, scores, max_output: int, iou_threshold: float):
    """The kernels of ``csrc/nms.cu`` on the unsorted boxes and scores and
    the sort order: the mask kernel gathers and zeroes the sorted boxes
    itself."""
    boxes, scores = boxes.contiguous(), scores.contiguous()
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    b, n = scores.shape
    words = (n + 63) // 64
    if words * 8 > 48 * 1024:
        raise ValueError(f"nms kernel takes at most {48 * 1024 * 8} boxes, got {n}")
    dev = boxes.device
    scratch = torch.empty(b * n * words + b * words, dtype=torch.int64, device=dev)  # mask, validity
    state = torch.empty(b * (2 + max_output), dtype=torch.int32, device=dev)  # between the phases
    idx = torch.empty((b, max_output), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_output), dtype=torch.bool, device=dev)
    status = _kernels.library().caesar_nms(
        boxes.data_ptr(), scores.data_ptr(), order.data_ptr(), b, n, float(iou_threshold),
        max_output, scratch.data_ptr(), state.data_ptr(), idx.data_ptr(), valid.data_ptr(), _stream(boxes),
    )
    _kernels.check(status, "caesar_nms")
    N.nms_padded.launches += 1
    return idx, valid


def _nms_cpu(boxes, scores, max_output: int, iou_threshold: float):
    return N.nms_sorted_plain(*N.sort_boxes(boxes, scores), max_output, iou_threshold)


def _nms_fake(boxes, scores, max_output: int, iou_threshold: float):
    shape = (boxes.shape[0], max_output)
    return boxes.new_empty(shape, dtype=torch.int32), boxes.new_empty(shape, dtype=torch.bool)


_register("nms(Tensor boxes, Tensor scores, int max_output, float iou_threshold) -> (Tensor, Tensor)",
          _nms_cpu, _nms_cuda, _nms_fake)


# ---------------------------------------------------------------- roi_align


def _roi_align_cuda(levels, boxes, image_shape, pool: int):
    b, n = boxes.shape[:2]
    c = levels[0].shape[-1]
    dtype = levels[0].dtype
    R._check_kernel_shapes("roi_align", dtype, c, pool, len(levels))
    # the wrapper checked the traced layout; a loaded program passes what
    # its operators produce at run time
    levels, boxes = [f.contiguous() for f in levels], boxes.contiguous()
    for f in levels:
        if f.shape[1] * f.shape[2] * c >= 2**31:
            raise ValueError("roi_align kernel needs each level's image below 2^31 elements")
    vector = R._vector_bytes(levels, c, levels[0].element_size())
    out = torch.empty((b, n, pool, pool, c), dtype=dtype, device=boxes.device)
    hw = [int(d) for f in levels for d in f.shape[1:3]]
    status = _kernels.library().caesar_roi_align(
        *(f.data_ptr() for f in levels), *hw, b, c, boxes.data_ptr(), n, pool,
        R._level_inv_denom(image_shape), R._DTYPES[dtype], vector, out.data_ptr(), _stream(boxes),
    )
    _kernels.check(status, "caesar_roi_align")
    R.roi_align.launches += 1
    return out


def _roi_align_cpu(levels, boxes, image_shape, pool: int):
    return R.roi_align_plain(levels, boxes, tuple(image_shape), pool)


def _roi_align_fake(levels, boxes, image_shape, pool: int):
    return levels[0].new_empty((boxes.shape[0], boxes.shape[1], pool, pool, levels[0].shape[-1]))


_register("roi_align(Tensor[] levels, Tensor boxes, int[] image_shape, int pool) -> Tensor",
          _roi_align_cpu, _roi_align_cuda, _roi_align_fake)


def _level_shapes(flat):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def _roi_align_backward_cuda(grad, boxes, level_shapes, image_shape):
    b, n, pool, _, c = grad.shape
    dtype = grad.dtype
    shapes = _level_shapes(level_shapes)
    R._check_kernel_shapes("roi_align_backward", dtype, c, pool, len(shapes))
    grad, boxes = grad.contiguous(), boxes.contiguous()
    if grad.data_ptr() % 16:
        raise ValueError("roi_align_backward kernel needs a 16-byte aligned grad_out")
    sizes = [b * h * w * c for h, w in shapes]
    scratch = torch.zeros(sum(sizes), dtype=torch.float32, device=grad.device)
    if n:  # no box, no gradient: nothing to launch
        hw = [int(d) for shape in shapes for d in shape]
        status = _kernels.library().caesar_roi_align_backward(
            *(g.data_ptr() for g in scratch.split(sizes)), *hw, b, c, boxes.data_ptr(), n, pool,
            R._level_inv_denom(image_shape), R._DTYPES[dtype], grad.data_ptr(), _stream(grad),
        )
        _kernels.check(status, "caesar_roi_align_backward")
        R.roi_align_backward.launches += 1
    return scratch if dtype == torch.float32 else scratch.to(dtype)  # one cast for all levels


def _roi_align_backward_cpu(grad, boxes, level_shapes, image_shape):
    grads = R.roi_align_backward_plain(grad, boxes, _level_shapes(level_shapes), tuple(image_shape))
    return torch.cat([g.reshape(-1) for g in grads])


def _roi_align_backward_fake(grad, boxes, level_shapes, image_shape):
    b, c = grad.shape[0], grad.shape[-1]
    return grad.new_empty((sum(b * h * w * c for h, w in _level_shapes(level_shapes)),))


# The level gradients leave as one flat tensor (the kernel sums them into one
# scratch buffer): an operator's outputs may not alias one another, so the
# wrapper cuts the per-level views.
_register("roi_align_backward(Tensor grad, Tensor boxes, int[] level_shapes, int[] image_shape) -> Tensor",
          _roi_align_backward_cpu, _roi_align_backward_cuda, _roi_align_backward_fake)


def _roi_align_setup(ctx, inputs, output):
    levels, boxes, image_shape, _ = inputs
    ctx.save_for_backward(boxes)
    ctx.image_shape = image_shape
    ctx.level_shapes = [tuple(f.shape[1:3]) for f in levels]


def _roi_align_grad(ctx, grad):
    (boxes,) = ctx.saved_tensors
    return R.roi_align_backward(grad.contiguous(), boxes, ctx.level_shapes, ctx.image_shape), None, None, None


# Boxes carry no gradient: the training graph detaches its ROIs.
torch.library.register_autograd(f"{NAMESPACE}::roi_align", _roi_align_grad, setup_context=_roi_align_setup,
                                lib=_LIB)


# ---------------------------------------------------------- crop_and_resize


def _crop_and_resize_cuda(masks, boxes, assign, crop_size):
    if assign.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"crop_and_resize kernel takes int32 or int64 assign, got {assign.dtype}")
    masks, boxes, assign = masks.contiguous(), boxes.contiguous(), assign.contiguous()
    b, r = assign.shape
    ph, pw = crop_size
    out = torch.empty((b, r, ph, pw), dtype=torch.float32, device=masks.device)
    _, h, w, g = masks.shape
    status = _kernels.library().caesar_crop_and_resize(
        masks.data_ptr(), b, h, w, g, boxes.data_ptr(), assign.data_ptr(), assign.element_size(), r, ph, pw,
        out.data_ptr(), _stream(masks),
    )
    _kernels.check(status, "caesar_crop_and_resize")
    R.crop_and_resize.launches += 1
    return out


def _crop_and_resize_cpu(masks, boxes, assign, crop_size):
    return R.crop_and_resize_plain(masks, boxes, assign, tuple(crop_size))


def _crop_and_resize_fake(masks, boxes, assign, crop_size):
    return masks.new_empty((assign.shape[0], assign.shape[1], crop_size[0], crop_size[1]))


_register("crop_and_resize(Tensor masks, Tensor boxes, Tensor assign, int[] crop_size) -> Tensor",
          _crop_and_resize_cpu, _crop_and_resize_cuda, _crop_and_resize_fake)


# -------------------------------------------------------------- paste_masks


def _paste_masks_cuda(detections, masks, frames, shape):
    """The kernel of ``csrc/paste_masks.cu`` into each frame's address (the
    device's, or pinned host memory's, which unified addressing maps)."""
    detections, masks = detections.contiguous(), masks.contiguous()
    b, d, mh, mw = masks.shape
    ptrs = (ctypes.c_void_p * b)(*(f.data_ptr() for f in frames))
    status = _kernels.library().caesar_paste_masks(
        detections.data_ptr(), masks.data_ptr(), b, d, mh, mw, shape[0], shape[1], ptrs,
        _sm_count(detections.device), _stream(detections),
    )
    _kernels.check(status, "caesar_paste_masks")
    P.paste_masks.launches += -(-b // P.TILES_PER_LAUNCH)


def _paste_masks_cpu(detections, masks, frames, shape):
    P.paste_masks_plain(detections, masks, frames, tuple(shape))


def _paste_masks_fake(detections, masks, frames, shape):
    return None


# frames: one flat bool tensor a tile, written in place (the first H * W * n
# elements); on CUDA, in device memory or pinned host memory
_register("paste_masks(Tensor detections, Tensor masks, Tensor(a!)[] frames, int[] shape) -> ()",
          _paste_masks_cpu, _paste_masks_cuda, _paste_masks_fake)


# -------------------------------------------------------------- quantize_int8


def _quantize_int8_cuda(x, s_in: float, channels):
    x = x.contiguous()
    c = x.shape[-1] if x.dim() else 1
    pad = channels is not None and channels != c
    q = torch.empty(x.shape[:-1] + (channels,) if pad else x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        lib = _kernels.library()
        if pad:
            status = lib.caesar_quantize_int8_pad(x.data_ptr(), q.data_ptr(), x.numel() // c, c, channels,
                                                  Q._QUANT_DTYPES[x.dtype], float(s_in), _stream(x))
        else:
            status = lib.caesar_quantize_int8(x.data_ptr(), q.data_ptr(), x.numel(), Q._QUANT_DTYPES[x.dtype],
                                              float(s_in), _stream(x))
        _kernels.check(status, "caesar_quantize_int8")
        Q.quantize_int8.launches += 1
    return q


def _quantize_int8_cpu(x, s_in: float, channels):
    q = Q.quantize_int8_plain(x, s_in)
    c = x.shape[-1] if x.dim() else 1
    return torch.nn.functional.pad(q, (0, channels - c)) if channels is not None and channels != c else q


def _quantize_int8_fake(x, s_in: float, channels):
    shape = x.shape if channels is None or x.dim() == 0 else x.shape[:-1] + (channels,)
    return x.new_empty(shape, dtype=torch.int8)


_register("quantize_int8(Tensor x, float s_in, int? channels) -> Tensor",
          _quantize_int8_cpu, _quantize_int8_cuda, _quantize_int8_fake)


# -------------------------------------------------------------- conv2d_int8

_WEIGHT_MAPS: Dict[tuple, ctypes.Array] = {}
_SPLIT_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _weight_map(w: torch.Tensor, kdim: int, cout: int, bn: int) -> ctypes.Array:
    """The TMA descriptor of packed weights, encoded once per (device,
    address, shape, tile): it holds no data, so it stays right for any
    tensor at that address."""
    key = (w.device.index, w.data_ptr(), kdim, cout, bn)
    tmap = _WEIGHT_MAPS.get(key)
    if tmap is None:
        if len(_WEIGHT_MAPS) > 4096:
            _WEIGHT_MAPS.clear()
        tmap = ctypes.create_string_buffer(128)
        _kernels.check(_kernels.library().caesar_conv_int8_weight_map(tmap, w.data_ptr(), kdim, cout, bn),
                       "caesar_conv_int8_weight_map")
        _WEIGHT_MAPS[key] = tmap
    return tmap


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SMs: the Hopper kernel's persistent blocks."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """Zeroed split-K counters, one per output tile, per device and stream
    (each launch leaves them zeroed, and launches on one stream run in
    order)."""
    key = (device.index, stream)
    t = _SPLIT_COUNTERS.get(key)
    if t is None or t.numel() < tiles:
        t = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _SPLIT_COUNTERS[key] = t
    return t


def _conv_mode(sw, s_next) -> str:
    """The epilogue: the int32 sums alone ("raw", no scales), f32, or int8
    requantized at ``s_next`` ("q8")."""
    return "raw" if sw is None else "f32" if s_next is None else "q8"


def _conv_out_shape(x, w, stride: int, pads):
    ho, wo = Q.out_size(tuple(x.shape[1:3]), w.shape[1], stride, ((pads[0], pads[1]), (pads[2], pads[3])))
    return x.shape[0], ho, wo, w.shape[0]


def _conv2d_int8_cuda(x, w, sw, b, stride: int, pads, relu: bool, s_next):
    if not w.is_contiguous():
        raise ValueError("conv2d_int8 kernel takes contiguous packed weights (its TMA map is cached by address)")
    x, w = Q.hopper_operands(x.contiguous(), w)
    bsz, h, wd, c = x.shape
    _, ho, wo, cout = _conv_out_shape(x, w, stride, pads)
    k = w.shape[1]
    mode = _conv_mode(sw, s_next)
    m, kdim = bsz * ho * wo, k * k * c
    sms = _sm_count(x.device)
    plan = Q.conv_plan(m, cout, kdim, sms)
    out = torch.empty((bsz, ho, wo, cout), dtype=Q._OUT_DTYPES[mode], device=x.device)
    stream = _stream(x)
    sw_p = b_p = 0
    if mode != "raw":
        sw, b = sw.contiguous(), b.contiguous()
        sw_p, b_p = sw.data_ptr(), b.data_ptr()
    tmap = _weight_map(w, kdim, cout, plan.bn)
    ws = counters = None
    if plan.splits > 1:
        tiles = -(-m // Q.TILE_M) * -(-cout // plan.bn)
        ws = torch.empty(plan.splits * tiles * Q.TILE_M * plan.bn, dtype=torch.int32, device=x.device)
        counters = _split_counters(x.device, stream, tiles)
    status = _kernels.library().caesar_conv2d_int8_wgmma(
        x.data_ptr(), tmap, sw_p, b_p, out.data_ptr(), 0 if ws is None else ws.data_ptr(),
        0 if counters is None else counters.data_ptr(), bsz, h, wd, c, ho, wo, cout, k, stride, pads[0],
        pads[2], int(relu), Q._MODES[mode], 0.0 if s_next is None else float(s_next), plan.bn, plan.splits, sms,
        stream,
    )
    _kernels.check(status, "caesar_conv2d_int8_wgmma")
    Q.conv2d_int8.launches += 1
    Q.conv2d_int8.route_launches["wgmma"] += 1
    return out


def _conv2d_int8_cpu(x, w, sw, b, stride: int, pads, relu: bool, s_next):
    pads = ((pads[0], pads[1]), (pads[2], pads[3]))
    if sw is None:
        return Q.conv2d_int8_accumulate_plain(x, w, stride, pads)
    return Q.conv2d_int8_plain(x, w, sw, b, stride, pads, relu, s_next)


def _conv2d_int8_fake(x, w, sw, b, stride: int, pads, relu: bool, s_next):
    return x.new_empty(_conv_out_shape(x, w, stride, pads), dtype=Q._OUT_DTYPES[_conv_mode(sw, s_next)])


# pads: (top, bottom, left, right); without sw and b the int32 sums alone
_register("conv2d_int8(Tensor x, Tensor w, Tensor? sw, Tensor? b, int stride, int[] pads, bool relu, "
          "float? s_next) -> Tensor", _conv2d_int8_cpu, _conv2d_int8_cuda, _conv2d_int8_fake)


ops = getattr(torch.ops, NAMESPACE)
