"""Seeded kernel cases, bounds and timing for the port's CUDA kernels.

``chip_smoke.py`` takes its kernel cases, its timer and its bounds from
here. Run as a script on the machine with the card, from the repository
root, it splits each call of NMS, the ROIAlign forward and backward and
crop_and_resize into the device kernels it launches (``torch.profiler``:
the port's own kernel against the PyTorch ops of its wrapper) and times
the whole call (CUDA events, median of :data:`REPS`), optionally beside
another checkout of the port:

    python3 -m caesar_mrcnn_tpu_torch.kernel_bench [--parent DIR] [--json PATH]

``--parent DIR`` loads ``DIR/caesar_mrcnn_tpu_torch`` as a second package
and measures both in turns (parent, change, change, parent) in one
process, on one card. A summary goes to stdout; ``--json PATH`` also
writes every record, with each call's full kernel split.

Its cases are seeded, and the inputs of one real flagship train step: the
RPN's boxes and scores before NMS, the sampled ROIs, and the mask-target
crop's GT masks, boxes and assignment, which ``chip_smoke.py`` saves to
``build/train_step_boxes.pt`` (run it first).

Bounds: the least time the card could take for the work, the larger of the
bytes the function must move (each input read once, each output written
once) over the memory rate and the operations over the f32 rate outside the
tensor cores, at the published H100 SXM peaks (3.35 TB/s, 67 TFLOP/s).
Where the work depends on the data, the count is this data's: the IoU
tests NMS's walk needs (:func:`nms_pairs`), the level pixels the ROIAlign
forward's taps touch (:func:`roi_align_pixels`), the 32-byte mask sectors
the crop's taps touch (:func:`crop_sectors`).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_INT8_PER_S = 1979e12  # dense int8 tensor-core operations
# f32 operations of one IoU test (4 min/max, 2 sub, 2 max, 1 mul for the
# intersection; 2 x (2 sub, 1 mul) for the areas; add, sub; div; compare)
NMS_OPS_PER_PAIR = 20

SEED = 0
REPS = 20  # timed calls per median
TRAIN_STEP_BOXES = Path(__file__).resolve().parent.parent / "build" / "train_step_boxes.pt"


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn: Callable, reps: int) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call
    (after one warm-up call)."""
    return median_ms_turns([fn], reps)[0]


def median_ms_turns(fns: Sequence[Callable], reps: int) -> List[float]:
    """Median device time (ms) of each of ``fns``, timed in turns (one call
    of each per round, CUDA events around each call, after one warm-up
    round), so that a drift of the card's clocks falls on all alike."""
    import torch

    for fn in fns:
        fn()
    times: List[List[float]] = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def device_split(fn: Callable, reps: int) -> Dict[str, Tuple[float, float]]:
    """Device time (ms) and launches per call of each kernel ``fn``
    launches, from a ``torch.profiler`` trace of ``reps`` calls (after one
    warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, Tuple[float, float]] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            out[evt.key[:90]] = (us / 1000.0 / reps, evt.count / reps)
    return out


# The port's kernels (``csrc/*.cu``); every other device op of a call is
# its wrapper's (casts, zeros, the sort).
OWN_KERNELS = ("nms_mask_kernel", "nms_sweep_kernel", "roi_align_kernel", "roi_align_backward_kernel",
               "crop_and_resize_kernel", "conv_int8_wgmma_kernel", "quantize_int8_kernel", "quantize_int8_pad_kernel")


def own_kernels(split: Dict[str, Tuple[float, float]]) -> Tuple[float, float, float]:
    """(ms of the port's own kernels, ms of the other device ops, launches
    of the other ops) per call, from a :func:`device_split`."""
    def own(key):
        return any(name in key for name in OWN_KERNELS)

    other = [(ms, n) for k, (ms, n) in split.items() if not own(k)]
    return sum(ms for k, (ms, _) in split.items() if own(k)), sum(ms for ms, _ in other), sum(n for _, n in other)


# -------------------------------------------------------------------- cases


def nms_case(rng, b: int, n: int, classes: bool):
    """Seeded boxes in clusters of near-duplicates, with exact score ties,
    -inf (invalid) scores and zero boxes; optionally class-offset."""
    centers = rng.uniform(0.0, 0.85, (b, n // 8 + 1, 2))
    sizes = rng.uniform(0.01, 0.15, (b, n // 8 + 1, 2))
    pick = rng.randint(0, centers.shape[1], (b, n))
    c = np.take_along_axis(centers, pick[..., None], 1)
    s = np.take_along_axis(sizes, pick[..., None], 1)
    jitter = rng.uniform(-0.004, 0.004, (b, n, 4))
    boxes = np.concatenate([c, np.minimum(c + s, 1.0)], -1) + jitter
    boxes = np.clip(boxes, 0.0, 1.0)
    boxes[rng.rand(b, n) < 0.02] = 0.0
    scores = np.round(rng.uniform(0.0, 1.0, (b, n)), 3)  # exact ties
    scores[rng.rand(b, n) < 0.05] = -np.inf
    if classes:
        boxes = boxes + 2.0 * rng.randint(1, 4, (b, n, 1))
    return boxes.astype(np.float32), scores.astype(np.float32)


def roi_case(rng, b: int, n: int):
    """Boxes of every size (all four levels), border-touching and zero."""
    y1 = rng.uniform(0.0, 0.9, (b, n))
    x1 = rng.uniform(0.0, 0.9, (b, n))
    h = np.exp(rng.uniform(np.log(0.01), 0.0, (b, n)))
    w = h * np.exp(rng.uniform(-0.7, 0.7, (b, n)))
    boxes = np.stack([y1, x1, np.minimum(y1 + h, 1.0), np.minimum(x1 + w, 1.0)], -1)
    boxes[:, ::7, 0] = 0.0
    boxes[:, ::11, 3] = 1.0
    boxes[:, ::13] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, -5:] = 0.0
    return boxes.astype(np.float32)


# NMS: the detect path's RPN (1000 kept) and per-class detection NMS, the
# train path's RPN (2000 kept): (B, N, threshold, max_output, class offset)
NMS_CASES = ((8, 6000, 0.9, 1000, False), (8, 1000, 0.3, 300, True), (8, 6000, 0.9, 2000, False))
# ROIAlign backward at the train path's shapes: (B, N, pool, C), 256^2 pyramid
BACKWARD_CASES = ((8, 512, 7, 256), (8, 168, 14, 256))
TRAIN_LEVELS = [(s, s) for s in (64, 32, 16, 8)]
# ROIAlign forward, B=8, C=256 bf16: detect (512^2: 1000 proposals at 7,
# 100 detections at 14) and train (256^2: 512 ROIs at 7, 168 positive
# slots at 14): (image side, N, pool)
FORWARD_CASES = ((512, 1000, 7), (512, 100, 14), (256, 512, 7), (256, 168, 14))
# crop_and_resize at the training flagship: f32 masks [B, H, H, G], R ROIs
# per image cropped to crop x crop
CROP_CASE = (8, 256, 300, 168, 28)


def pyramid(rng, dev, b: int, image: int, c: int):
    """Seeded bf16 P2..P5 levels [B, image/4 .. image/32, C]."""
    import torch

    return [torch.from_numpy(rng.randn(b, s, s, c).astype(np.float32)).to(dev, torch.bfloat16)
            for s in (image // 4, image // 8, image // 16, image // 32)]


def crop_case(rng, dev, b: int, h: int, g: int, r: int):
    """Seeded binary f32 masks [B, H, H, G] (drawn on ``dev``), boxes of
    every size (one per image partly outside the map) and int64 channels."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    masks = (torch.rand((b, h, h, g), generator=gen, device=dev) > 0.7).float()
    boxes = roi_case(rng, b, r)
    boxes[:, 3] = [-0.1, 0.2, 0.5, 1.2]  # partly outside the map
    return masks, torch.from_numpy(boxes).to(dev), torch.from_numpy(rng.randint(0, g, (b, r))).to(dev)


# ------------------------------------------------------------------- bounds


def _bound(nbytes: float, ops: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_pairs(scores, idx, valid, max_output: int) -> int:
    """The IoU tests greedy NMS needs on this data: each kept box against
    every later box up to the position at which the walk stops (the
    ``max_output``-th kept box, or the last box), from the result
    ``(idx, valid)`` of :func:`nms_padded` on ``scores``."""
    import torch

    b, n = scores.shape
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=order.device).expand(b, n))
    pos = torch.gather(rank, 1, idx.long())  # sorted position of each kept slot
    full = valid.sum(1) >= max_output
    stop = torch.where(full, pos.masked_fill(~valid, -1).amax(1) + 1, torch.full_like(pos[:, 0], n))
    return int(((stop[:, None] - 1 - pos) * valid).sum())


def nms_bound(b: int, n: int, max_output: int, pairs: int) -> Tuple[float, str]:
    """Boxes and scores read, indices and flags written; ``pairs`` IoU
    tests (:func:`nms_pairs`)."""
    return _bound(b * n * 20 + b * max_output * 5, pairs * NMS_OPS_PER_PAIR)


def _axis_taps(lo, hi, extent, n: int):
    """Along one axis of ``extent`` pixels (a float, or a tensor shaped like
    ``lo``): whether each of the n samples between ``lo`` and ``hi`` lies
    inside the map, and its two taps, [..., n] each, where the kernels
    sample (``csrc/sampling.cuh``)."""
    import torch

    from .ops.roi_align import _sample_coords

    em1 = torch.as_tensor(extent, dtype=torch.float32, device=lo.device).expand_as(lo) - 1.0
    pos = _sample_coords(lo, hi, em1, n)
    em1 = em1[..., None]
    t0 = torch.minimum(torch.floor(pos).clamp_min(0.0), em1)
    t1 = torch.minimum(t0 + 1.0, em1)
    return (pos >= 0) & (pos <= em1), t0.long(), t1.long()


def _corner_taps(boxes, extent_y, extent_x, ph: int, pw: int):
    """The four taps (y, x) of every sample [..., ph, pw], and which
    samples lie inside the map (the others read nothing)."""
    iny, y0, y1 = _axis_taps(boxes[..., 0], boxes[..., 2], extent_y, ph)
    inx, x0, x1 = _axis_taps(boxes[..., 1], boxes[..., 3], extent_x, pw)
    taps = [(y[..., :, None], x[..., None, :]) for y in (y0, y1) for x in (x0, x1)]
    return taps, iny[..., :, None] & inx[..., None, :]


def roi_align_pixels(boxes, level_shapes: Sequence[Tuple[int, int]], image_shape: Tuple[int, int],
                     pool: int) -> int:
    """Distinct level pixels (image, level, y, x) that the taps of the
    boxes' samples read, each box on its FPN level (``roi_levels``)."""
    import torch

    from .ops.roi_align import roi_levels

    b = boxes.shape[0]
    dev = boxes.device
    shapes = torch.tensor(level_shapes, dtype=torch.int64, device=dev)
    sizes = shapes[:, 0] * shapes[:, 1]
    level = roi_levels(boxes, float(image_shape[0] * image_shape[1]), len(level_shapes)).long()
    h, w = shapes[level, 0], shapes[level, 1]  # [B, N]
    base = (sizes.cumsum(0) - sizes)[level] + torch.arange(b, device=dev)[:, None] * int(sizes.sum())
    taps, inside = _corner_taps(boxes, h.float(), w.float(), pool, pool)
    base, w = base[..., None, None], w[..., None, None]
    return int(torch.unique(torch.cat([(base + y * w + x)[inside] for y, x in taps])).numel())


def crop_sectors(mask_shape: Sequence[int], boxes, assign, crop_size: Tuple[int, int]) -> int:
    """Distinct 32-byte sectors of the f32 masks [B, H, W, G] (allocated on
    a 32-byte boundary) that the taps of the crop's samples read from each
    box's assigned channel."""
    import torch

    b, h, w, g = mask_shape
    taps, inside = _corner_taps(boxes, float(h), float(w), *crop_size)
    img = torch.arange(b, device=boxes.device)[:, None, None, None]
    ch = assign.long()[:, :, None, None]
    elems = torch.cat([(((img * h + y) * w + x) * g + ch)[inside] for y, x in taps])
    return int(torch.unique(elems // 8).numel())  # 8 floats per sector


def roi_align_bound(boxes, level_shapes: Sequence[Tuple[int, int]], image_shape: Tuple[int, int], pool: int,
                    c: int, itemsize: int) -> Tuple[float, str]:
    """The level pixels the taps touch (:func:`roi_align_pixels`) and the
    boxes read, [B, N, pool, pool, C] written; 4 products and 3 sums per
    output element, plus the 3 weight products."""
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
    """The mask sectors the taps touch (:func:`crop_sectors`: the card
    reads no less than a 32-byte sector per distinct tap when the channel
    stride is 32 bytes or more), boxes and assignment read, f32 crops
    written; 3 lerps per sample."""
    b, r = assign.shape
    samples = b * r * crop_size[0] * crop_size[1]
    nbytes = crop_sectors(mask_shape, boxes, assign, crop_size) * 32 + b * r * (16 + assign.element_size())
    return _bound(nbytes + samples * 4, samples * 12)


# ------------------------------------------------------- the int8 serving graph


class ConvSite(NamedTuple):
    """One int8 convolution of the detect graph: its site, NHWC input
    [batch, h, w, cin], ``cout`` filters of ``k`` x ``k`` at ``stride``,
    XLA's ``pads`` ((top, bottom), (left, right)), whether a ReLU ends it,
    ``then``, the one quantized convolution that reads its output, where
    there is one (the output then leaves int8, quantized in the
    epilogue), and ``in_bytes``, the bytes per value of the float input the
    graph hands it (4 f32, 2 bf16), which its quantizer reads where no
    producer requantized for it."""

    name: str
    batch: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    pads: tuple
    relu: bool = False
    then: Optional[str] = None
    in_bytes: int = 4

    @property
    def out_hw(self) -> Tuple[int, int]:
        (pt, pb), (pl, pr) = self.pads
        return (self.h + pt + pb - self.k) // self.stride + 1, (self.w + pl + pr - self.k) // self.stride + 1

    @property
    def read_hw(self) -> Tuple[int, int]:
        """The input rows and columns some tap reads (a 1x1 stride-2 conv
        reads every other one)."""
        def touched(n_in, n_out, lo):
            return len({o * self.stride - lo + t for o in range(n_out) for t in range(self.k)} & set(range(n_in)))

        (pt, _), (pl, _) = self.pads
        ho, wo = self.out_hw
        return touched(self.h, ho, pt), touched(self.w, wo, pl)

    @property
    def m(self) -> int:  # output pixels: the GEMM's M
        ho, wo = self.out_hw
        return self.batch * ho * wo

    @property
    def kdim(self) -> int:  # the GEMM's K
        return self.k * self.k * self.cin

    @property
    def ops(self) -> int:  # a multiply and an add per (pixel, filter, tap)
        return 2 * self.m * self.cout * self.kdim


def int8_sites(cfg, rois: int, detections: int) -> List[ConvSite]:
    """Every int8 convolution one detect batch of ``cfg`` runs, in order,
    with ``rois`` proposals (the classifier's input) and ``detections``
    (the mask head's) per image: the int8 stages' own topology
    (``heads_int8.DetectStages``), walked on shape-only tensors (PyTorch's
    meta device) in the model's compute dtype, with a conv that records
    each site."""
    import torch
    from torch import nn

    from .models.heads_int8 import DetectStages, site_module
    from .models.mask_rcnn import MaskRCNN, compute_dtype
    from .ops.quant import out_size, pad_for, xla_pads

    sites: List[ConvSite] = []
    with torch.device("meta"):
        model = MaskRCNN(cfg)

    class Recorder(nn.Module):
        def forward(self, site, x, stride=1, relu=False, then=None):
            cout, cin, k, _ = site_module(model, site).weight.shape
            b, h, w, c = x.shape
            pads = xla_pads(pad_for(site), k, stride, (h, w))
            sites.append(ConvSite(site, b, h, w, c, cout, k, stride, pads, relu, then, x.element_size()))
            return x.new_empty((b, *out_size((h, w), k, stride, pads), cout), dtype=torch.float32)

    dtype = compute_dtype(cfg)
    stages = DetectStages(model, Recorder(), dtype)
    h, w, c = cfg.image_shape
    b, ch = cfg.batch_size, cfg.top_down_pyramid_size
    with torch.device("meta"):  # the heads take ROIAlign's output in the compute dtype
        stages.rpn(stages.features(torch.empty(b, h, w, c)))
        stages.classifier(torch.empty(b, rois, cfg.pool_size, cfg.pool_size, ch, dtype=dtype))
        stages.mask(torch.empty(b, detections, cfg.mask_pool_size, cfg.mask_pool_size, ch, dtype=dtype))
    return sites


# the serving flagship's sites that chip_smoke.py checks and times: the stem
# (K = 147, 784 with its channels padded to 16), a 1x1/2, a 3x3, a 1x1 at
# K = 2048 (split-K), the RPN's largest level, fc1 (K = 12,544) and the mask
# head's first 3x3; and one site that requantizes for the next
# (bb/res4b/conv1 -> bb/res4b/conv2)
CONV_INT8_SITES = ("bb/conv1", "bb/res3a/conv1", "bb/res4b/conv2", "fpn/c5p5", "rpn/shared@p2", "cls/conv1",
                   "mask/conv1")
CONV_INT8_FUSED_SITE = "bb/res4b/conv1"


def conv_int8_bound(site: ConvSite) -> Tuple[float, str]:
    """The int8 input the taps touch (:attr:`ConvSite.read_hw`) and the
    weights read once and the output written once (f32, or int8 where the
    site requantizes for ``then``) over the memory rate, against the int8
    operations over the dense int8 tensor-core rate; the larger, in ms.
    ``site._replace(then=None)`` gives the unfused graph's bound."""
    rows, cols = site.read_hw
    out_bytes = 1 if site.then else 4
    nbytes = site.batch * rows * cols * site.cin + site.cout * site.kdim + site.m * site.cout * out_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, site.ops / PEAK_INT8_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_bound(n_weights: int, n_channels: int, itemsize: int) -> Tuple[float, str]:
    """A table of (conv, batch norm) pairs folded: each f32 weight read and
    written once in ``itemsize`` bytes, multiplied once; each output
    channel's five f32 vectors read and its bias written, six operations."""
    return _bound(n_weights * (4 + itemsize) + n_channels * (5 * 4 + itemsize), n_weights + 6 * n_channels)


def quantize_bound(n: int, itemsize: int, n_out: Optional[int] = None) -> Tuple[float, str]:
    """n values of ``itemsize`` bytes read and ``n_out`` int8 written (n,
    or more where the quantizer pads channels with zeros); a division, a
    rounding and two clamps per value read, in f32."""
    return _bound(n * itemsize + (n if n_out is None else n_out), n * 4)


def input_quantize_bound(site: ConvSite) -> Tuple[float, str]:
    """The bound of the quantizer pass in front of ``site``, where no
    producer requantized for it: its float input read at ``in_bytes``, and
    int8 written with the channels padded to the Hopper kernel's multiple of
    16 (the stem's 3 to 16)."""
    from .ops.quant import padded_channels

    pixels = site.batch * site.h * site.w
    return quantize_bound(pixels * site.cin, site.in_bytes, pixels * padded_channels(site.cin))


# --------------------------------------------------------------- the script


def load_tree(path: str, alias: str):
    """The port package of another checkout, imported as ``alias``."""
    init = Path(path).resolve() / "caesar_mrcnn_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def _cases(dev):
    """(name, kind, inputs, bound) of every case; NMS's bound is None (it
    needs the kernel's result)."""
    import torch

    if not TRAIN_STEP_BOXES.exists():
        raise SystemExit(f"kernel_bench: no {TRAIN_STEP_BOXES}; python3 chip_smoke.py saves a train step's inputs there")
    step = torch.load(TRAIN_STEP_BOXES)
    rng = np.random.RandomState(SEED)
    nms = [(f"nms B={b} N={n} thr={thr} max_output={max_out}" + (" class offset" if classes else ""),
            *(torch.from_numpy(a).to(dev) for a in nms_case(rng, b, n, classes)), max_out, thr)
           for b, n, thr, max_out, classes in NMS_CASES]
    boxes, scores, max_out, thr = step["nms"]
    nms.append((f"nms train-step RPN B={boxes.shape[0]} N={boxes.shape[1]} thr={thr} max_output={max_out}",
                boxes.to(dev), scores.to(dev), max_out, thr))
    cases = [(name, "nms", inputs, None) for name, *inputs in nms]

    levels = {}
    forward = [(f"seeded {image}^2", image, torch.from_numpy(roi_case(rng, 8, n)).to(dev), pool)
               for image, n, pool in FORWARD_CASES]
    forward += [("train-step 256^2", 256, rois.to(dev), pool) for pool, rois in sorted(step["rois"].items())]
    for label, image, boxes, pool in forward:
        if image not in levels:
            levels[image] = pyramid(rng, dev, 8, image, 256)
        b, n = boxes.shape[:2]
        lv = levels[image]
        bound = roi_align_bound(boxes, [tuple(f.shape[1:3]) for f in lv], (image, image), pool, 256, 2)
        cases.append((f"roi_align {label} bf16 B={b} N={n} pool={pool} C=256", "forward",
                      (lv, boxes, (image, image), pool), bound))

    for b, n, pool, c in BACKWARD_CASES:
        for label, boxes in (("seeded", torch.from_numpy(roi_case(rng, b, n))), ("train-step", step["rois"][pool])):
            boxes = boxes.to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                grad = torch.from_numpy(rng.randn(b, n, pool, pool, c).astype(np.float32)).to(dev, dtype)
                name = f"roi_align_backward {label} {str(dtype)[6:]} B={b} N={n} pool={pool} C={c}"
                bound = roi_align_backward_bound(b, TRAIN_LEVELS, n, pool, c, grad.element_size())
                cases.append((name, "backward", (grad, boxes, TRAIN_LEVELS, (256, 256)), bound))

    b, h, g, r, crop = CROP_CASE
    masks, boxes, assign, size = step["crop"]
    for label, (m, bx, a, sz) in (("seeded", (*crop_case(rng, dev, b, h, g, r), (crop, crop))),
                                  ("train-step", (masks.to(dev).float(), boxes.to(dev), assign.to(dev), size))):
        bound = crop_and_resize_bound(m.shape, bx, a, sz)
        cases.append((f"crop_and_resize {label} masks {list(m.shape)} R={a.shape[1]} {sz[0]}x{sz[1]}", "crop",
                      (m, bx, a, sz), bound))
    return cases


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose port is measured beside this one")
    ap.add_argument("--json", help="write the records here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    trees = {"change": importlib.import_module("caesar_mrcnn_tpu_torch")}
    if args.parent:
        trees["parent"] = load_tree(args.parent, "parent_port")
    ops = {}
    for label, pkg in trees.items():
        nms = importlib.import_module(pkg.__name__ + ".ops.nms")
        roi = importlib.import_module(pkg.__name__ + ".ops.roi_align")
        ops[label] = {"nms": nms.nms_padded, "backward": roi.roi_align_backward, "forward": roi.roi_align,
                      "crop": roi.crop_and_resize}
    order = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    records = []
    for case, kind, inputs, bound in _cases(torch.device("cuda")):
        if kind == "nms":  # the pairs this data needs, from the change's result
            boxes, scores, max_out, _ = inputs
            pairs = nms_pairs(scores, *ops["change"]["nms"](*inputs), max_out)
            bound = nms_bound(*scores.shape, max_out, pairs)
        bound_ms, bound_by = bound
        rec = {"case": case, "bound_ms": bound_ms, "bound_by": bound_by, "ms": {k: [] for k in trees}}
        for label in order:
            fn = ops[label][kind]
            rec["ms"][label].append(median_ms(lambda: fn(*inputs), REPS))
        rec["split"] = {label: device_split(lambda: ops[label][kind](*inputs), REPS) for label in trees}
        for label in trees:
            split = rec["split"][label]
            own, other, launches = own_kernels(split)
            rec.setdefault("own_ms", {})[label] = own
            rec.setdefault("wrapper_ops", {})[label] = (other, launches)
            top = sorted(split.items(), key=lambda kv: -kv[1][0])
            print(f"{case} [{label}]: {' / '.join(f'{t:.4f}' for t in rec['ms'][label])} ms (median of {REPS}, "
                  f"CUDA events); device {own + other:.4f} ms: own kernels {own:.4f}, wrapper ops {other:.4f} "
                  f"({launches:g} launches); "
                  + "; ".join(f"{k[:60]} {v[0]:.4f}" for k, v in top[:6])
                  + f"; bound {bound_ms:.4f} ms ({bound_by}), kernel share {bound_ms / max(own, 1e-9):.3f} [{name}]")
        records.append(rec)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": name, "records": records}, indent=1))


if __name__ == "__main__":
    main()
