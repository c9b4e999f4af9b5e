#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``caesar_mrcnn_tpu_torch``) on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, one line each:

1. device: the card's name and power limit; TF32 is switched off;
2. build: the CUDA kernels, compiled from ``caesar_mrcnn_tpu_torch/csrc``
   (one nvcc per source, in parallel), and the native host library
   (``caesar_mrcnn_tpu_torch/native``), which must load;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the detect and train paths give it, with median times, the
   bound (the least time the card could take: bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, whichever is larger, counted from this
   run's data: NMS's IoU tests, the level pixels and mask sectors the
   ROIAlign forward's and the crop's taps touch; int8 operations over
   1,979 TOPS for the int8 convolution) and the roofline share; the int8
   convolution at seven sites of the serving flagship and at one that
   requantizes for the next (the Hopper kernel: int32 sums equal, f32
   outputs and the requantized int8 bit-equal), timed beside the unfused
   pair it replaces, ``torch._int_mm`` and cuDNN's bf16 conv, and the
   quantizer (bit-equal, on .5 ties too);
4. slice: the tiled detect path (``Detector.dispatch_tiles`` / ``collect``,
   two batches in flight) over 16 tiles of 512^2 read from a seeded 2048^2
   FITS mosaic, at the flagship's full width (ResNet-101, FPN 256, batch 8,
   bf16, 6000 pre-NMS / 1000 post-NMS / 100 detections): launches (2 NMS,
   2 ROIAlign and 1 mask paste per batch); then the masks' paste kernel
   (``ops/paste.py``) bit-equal to its plain version (the host unmold's
   paste) at the path's shape (8 tiles of 512^2, 100 detections a tile),
   on a batch of the slice's own detections, on seeded boxes of up to the
   whole tile (``testing.paste_inputs``) and with every box the whole tile
   (the in-box work's worst case), into pinned host frames (as
   the path writes them) and into device frames: median times beside the
   plain version's, the bound the kept frames' bytes written once over
   PCIe 5.0 x16 (63 GB/s a direction) or over HBM;
5. parity: one tile at f32 through the card's detector and the same
   detector on the CPU, where the plain versions run;
6. catalog: the host layer, ``SFinder.run_tiled``, over the same mosaic
   at the same width (16 tiles, batch 8, bf16): launches (2 NMS, 2
   ROIAlign and 1 mask paste per batch), the catalog and DS9 file written and read back,
   sources, merged and edge sources; then a timed second run: wall
   seconds, tiles/s, the detector's share (dispatch, wait, unmold) and
   SFinder's own host steps (per-tile analysis, merge, source parameters,
   writing);
7. catalog parity: ``SFinder.run_tiled`` at f32 with pinned heads
   (``testing.pin_heads``) over a seeded 1024^2 mosaic (4 tiles, batch 4,
   a bright block straddling a tile boundary), on the card and on the CPU:
   the two catalogs equal (sources, boxes, pixels and contours exactly;
   scores within 1e-5; source parameters within 1e-6 relative);
8. train: 20 Adam steps of the training flagship (ResNet-101, FPN 256,
   256^2, batch 8, bf16, 2000 post-NMS proposals, 512 ROIs, 300 GT) on a
   seeded 16-image FITS dataset read through ``SourceDataset`` and the
   port's ``TrainingPipeline`` (compact wire); then all four kernels
   against their plain versions on the inputs of the last step (its RPN
   boxes before NMS, its sampled ROIs, its mask-target crop's GT masks,
   boxes and channels), which are saved to ``build/train_step_boxes.pt``
   for ``caesar_mrcnn_tpu_torch/kernel_bench.py``;
9. train parity: one f32 SGD step of ResNet-101 at batch 2, 128^2, on the
   card and on the CPU from the same weights, batch and priorities: losses
   and gradients;
10. train options: each training option ported last, at the training
   flagship's width through ``TrainingPipeline`` on the same 16 images, 8
   Adam steps each: ``train_bn=True`` (batch statistics, committed every
   step), ``train_remat="backbone"`` and ``"all"`` (recomputed in the
   backward) and ``opt_state_dtype="bfloat16"`` (the first moment in bf16):
   step ms, img/s, peak memory, first and last loss, launches (1 NMS, 2
   ROIAlign forward, 2 backward, 1 crop a step under every option). Held
   per step, not along a trajectory: one f32 ``train_bn`` SGD step of
   ResNet-101 (batch 2, 128^2) card vs CPU from the same state (losses,
   committed running statistics; the gradients against the same step in
   f64 on the CPU, within a multiple of the CPU's f32 distance from it),
   and each remat step against
   the same step without remat on the card; then the four kernels against
   their plain versions on the first ``train_bn`` step's inputs;
11. dist: data parallelism (ROADMAP A13) on the one card. Two ranks spawned
   (``torch.multiprocessing``) over Gloo, both on ``cuda:0``: 3 f32 SGD
   steps of the training flagship's widths (global batch 8, 4 per rank,
   2000 given ROIs, 512 ROIs, 300 GT, given global priorities). Held: each
   step against one process's step on the global batch from the same
   parameters and optimizer state (losses within 1e-4 relative; the
   gradients and the optimizer's trace within the relative L2 bounds of
   ``train parity:``); the trajectory against one process's (losses
   within 1e-4, the parameters after step 3 within those bounds); the
   ranks' parameters bit-equal. Printed beside it, not held: two
   one-process runs against each other, and the updates, which are below
   the f32 resolution of the parameters here. Then ``train_bn`` with the
   global batch's statistics (each batch norm's sums all-reduced under
   autograd; the batches' mean pixel): 2 f32 SGD steps, each against one
   process's step from the same state (losses, gradients, trace, committed
   statistics), the batch norm layer alone against one process (output,
   input and parameter gradients), the ranks' parameters and statistics
   bit-equal, and the step's time with the
   statistics' 2 x 110 all-reduces timed one by one. Then 12 bf16 Adam steps
   through the RPN path: each rank's median step ms, host ms to make its
   batch and the gradient all-reduce's ms and MB (Gloo takes the CUDA
   buckets) beside one process at batch 4 (not a scaling figure: the ranks
   share the card); the multi-process ``SFinder.run_tiled`` (the f32
   pinned-heads catalog of ``catalog parity:``'s mosaic equal to one
   process's exactly, then the bf16 flagship on the 2048^2 mosaic, its
   catalog files checked). Then one NCCL rank (world size 1) through a
   train step's all-reduce, the ``Detector`` over ``[cuda:0, cuda:0]``
   (two replicas, f32, a tile each) within 1e-5 of the one-device
   ``Detector``, and ``build_detector``'s shrink of ``num_devices=2`` to
   the one card (its warning). Last, each kernel of the path against its
   plain version on the inputs the path gave it: rank 0's first parity step
   (f32, 4 images: ROIAlign forward and backward at pool 7 and 14, the
   mask-target crop), its first timed step (bf16: the RPN's NMS as well)
   and replica 0's detect step (f32, one 512^2 tile: both NMS, ROIAlign at
   pool 7 and 14);
12. serving: the int8 serving graph (``quant_mode="int8"``, the CLI's
   ``--serving`` preset: 3000 pre-NMS / 512 post-NMS) at the serving
   flagship's width (ResNet-101, FPN 256, batch 8, bf16), on the 16 tiles
   of the seeded 2048^2 mosaic through ``dispatch_tiles``/``collect``, two
   batches in flight: the first batch calibrates it (wall time); launches
   (123 ``conv2d_int8`` per batch, every one on the Hopper kernel, and 53
   ``quantize_int8``: the other 70 quantizers run in convolution
   epilogues; 2 NMS and 2 ROIAlign per batch and 2 of each for the
   calibration); a timed third
   pass (img/s); the int8 detect step beside the bf16 graph's on the same
   weights and tiles (CUDA events), its device time by kernel (profiler);
   peak memory; the int8 pyramid's relative L2 error against the folded
   f32 graph's (bound 0.25, as ``tests/test_quant.py``);
13. serving parity: one quantized tree, calibrated on the CPU, carried to
   the card (f32, 256^2, batch 2): the int8 pyramid on the card equal to the
   CPU's bit for bit, and ``SFinder.run_tiled`` with pinned heads over a
   seeded 512^2 mosaic (4 tiles) giving the same catalog on both;
14. export: the serving export (``inference/export.py``) of the serving
   flagship's bf16 graph and of its int8 graph (calibrated on the first
   batch of the 16 tiles, as ``serving:`` does): export, save and load
   seconds, the artifact's MB and its ``caesar::`` nodes; each artifact
   loaded by ``ServingDetector`` in a fresh process that imports nothing of
   ``models/``, which runs the program once on a molded batch of 8
   (launches: 2 NMS and 2 ROIAlign, and 123 ``conv2d_int8`` on the Hopper
   kernel and 53 ``quantize_int8`` in the int8 graph; the outputs bit for
   bit against ``Detector._step``'s on the same batch, or within 1 bf16
   ulp for the bf16 graph) and detects on the 16 tiles
   (``ServingDetector.detect`` img/s beside ``Detector.detect``'s);
15. cli: the system's own entry point, ``caesar_mrcnn_tpu_torch.cli.run.main``,
   in-process on the card (its default ``--device cuda``), at the CLI's
   default widths (ResNet-101, bf16, 6000 pre-NMS, 2000/1000 post-NMS, 512
   ROIs, 300 GT): ``train`` (10 Adam steps at 256^2, batch 8, on the 16
   seeded FITS images, 2 validation steps, a ``.pt`` checkpoint), a resume
   from it (4 micro-steps, ``--grad_accum_steps 2``), ``test`` on the same
   images (``map_summary.json`` read back) and tiled ``detect`` on the
   seeded 2048^2 mosaic (catalog JSON and DS9 file read back), then
   ``detect --serving`` and ``test --serving`` (the int8 graph): each
   mode's wall time and launches; the train step's time and first and last
   losses;
16. classify: the classifier CLI, ``caesar_mrcnn_tpu_torch.cli.sclassifier.main``,
   in-process on the card, on a seeded 1024^2 synthetic sky
   (``data/synthetic.py``: 4 x 4 samples of 256^2) and its Caesar ascii
   catalog, with 256^2 cutouts at the serving flagship's width (ResNet-101,
   FPN 256, bf16, 4+1 classes) and inference batch 1, settled random
   weights saved as a ``.pt``: sources (every object of the sky, those at
   the left and top edges on clamped cutouts), cutouts run and sources
   classified, launches (2 NMS and 2 ROIAlign per cutout, exactly), wall
   seconds and ms per cutout, and the catalog read back; NMS and ROIAlign
   against their plain versions on the inputs of one of the path's detect
   calls (batch 1: the RPN's 6000 boxes, the per-class NMS's 1000, the
   cutout's own bf16 pyramid with its 1000 proposals at pool 7 and 100
   detections at pool 14); then the same CLI at f32 with pinned heads on
   six sources at 128^2 cutouts, on the card and with ``--device cpu``:
   the two catalogs equal row for row (scores within 1e-5).

Then the card's name and power limit, one JSON line with the kernels'
record (launches on the main paths: detect, catalog, train, train
options, dist (its two ranks' and the two replicas'), serving, export, cli
and classify; error,
kernel, plain and bound times summed over the cases; ``library_ms`` null,
with the reason beside it, but for the int8 convolution: ``torch._int_mm``
at the sites where one matrix product computes its int32 sums), and as the
last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result line. It needs a CUDA device and never falls
back to the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time

import numpy as np

SEED = 0
# Why no single PyTorch call stands beside each kernel (library_ms null).
NO_LIBRARY = {
    "nms": "none: no PyTorch call computes greedy NMS (torchvision is not installed, and the port may not use it)",
    "roi_align": "none: F.grid_sample samples one map per call and blends samples partly outside it; the "
                 "per-box FPN level needs a gather first",
    "roi_align_backward": "none: no PyTorch call scatters bilinear taps into four levels",
    "crop_and_resize": "none: F.grid_sample cannot pick each box's mask channel and blends samples partly "
                       "outside the map",
    "conv2d_int8": "torch._int_mm (the int32 sums alone, no epilogue) at the sites where one matrix product "
                   "computes them (a 1x1 stride-1 conv; a VALID conv whose window covers its input); PyTorch "
                   "has no int8 convolution on CUDA for the others",
    "quantize_int8": "none: torch.quantize_per_tensor multiplies by the reciprocal of the scale and clips to "
                     "[-128, 127]; the JAX graph divides and clips to +-127",
    "fold_conv_bn": "none: no PyTorch call folds a table of batch norms into their convolutions; a loop of "
                    "mul and sub calls launches several kernels a pair",
    "paste_masks": "none: F.interpolate takes one output size a call and every detection has its own box, and no "
                   "PyTorch call writes a device result into pinned host memory",
}
PCIE_BYTES_PER_S = 63.0e9  # PCIe 5.0 x16, one direction: the paste's frames in pinned host memory


def share(bound_ms: float, ms: float) -> str:
    return f"bound {bound_ms:.4f} ms, roofline share {bound_ms / ms:.3f}"


CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")


def train_config(**overrides):
    """The training flagship of ``bench_train.py``: ResNet-101, 256^2,
    batch 8, bf16, Adam, 300 GT, full-size masks, 512 ROIs."""
    from caesar_mrcnn_tpu_torch.config import detector_config

    kw = dict(
        num_classes=4, class_names=CLASS_NAMES, image_min_dim=256, image_max_dim=256,
        images_per_device=8, compute_dtype="bfloat16", optimizer="adam",
    )
    kw.update(overrides)
    return detector_config(**kw)


def flagship_config(**overrides):
    """The serving flagship: ResNet-101, 512^2, batch 8, bf16, 6000/1000."""
    from caesar_mrcnn_tpu_torch.config import detector_config

    kw = dict(
        num_classes=4, class_names=CLASS_NAMES, image_min_dim=512,
        image_max_dim=512, images_per_device=8, compute_dtype="bfloat16",
    )
    kw.update(overrides)
    return detector_config(**kw)


def settle_random_weights(model) -> None:
    """Random weights on raw 0..255 pixels saturate every softmax (all RPN
    scores tie at 1.0, every ROI is background). Scaling the stem by 1/255
    puts the input in [0, 1], and a -3 background logit bias lets
    foreground classes win, so the slice produces detections to check."""
    import torch

    with torch.no_grad():
        model.backbone.conv1.weight.mul_(1.0 / 255.0)
        model.classifier_head.mrcnn_class_logits.bias[0] = -3.0


def randomize_affine(model, seed: int = SEED) -> None:
    """Nonzero biases and batch norms (scale 0.5..1.5, var 0.5..2, the rest
    +-0.1, seeded), so that no tensor starts at 0 and a parameter's
    relative difference after a step measures its gradient's."""
    import torch

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if leaf != "weight":
                low, high = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(leaf, (-0.1, 0.1))
                t.copy_(torch.from_numpy(rng.uniform(low, high, tuple(t.shape)).astype(np.float32)))


# ------------------------------------------------------------------ kernels


def bf16_ulp(x):
    """One bf16 ulp at each value of the f32 tensor ``x`` (8 significant
    bits); 2^-133 at zero, so an exact zero must be matched exactly."""
    import torch

    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), torch.where(x == 0, -125, e) - 8)


def _record() -> dict:
    """A kernel's sums over its cases; ``by`` is the bound's ms by kind."""
    return {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "by": {"bytes": 0.0, "operations": 0.0}}


def _add(rec: dict, err: float, ms: float, plain_ms: float, bound) -> None:
    rec["err"] = max(rec["err"], err)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    rec["bound_ms"] += bound[0]
    rec["by"][bound[1]] += bound[0]


def nms_against_plain(rec: dict, boxes, scores, max_out: int, thr: float, label: str, card_name: str) -> None:
    """The kernel equal to its plain version entry for entry, then timed."""
    import torch

    from caesar_mrcnn_tpu_torch.ops import nms as N

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    b, n = scores.shape

    def kernel():
        return N.nms_padded(boxes, scores, max_out, thr)

    def plain():
        return N.nms_sorted_plain(*N.sort_boxes(boxes, scores), max_out, thr)

    ki, kv = kernel()
    pi, pv = plain()
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi.to(ki.dtype)) and torch.equal(kv, pv)):
        bad = int((ki != pi).sum() + (kv != pv).sum())
        raise AssertionError(f"nms {label}: {bad} entries differ from the plain version")
    ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 3)
    bound = kb.nms_bound(b, n, max_out, kb.nms_pairs(scores, ki, kv, max_out))
    print(f"kernels: nms {label} B={b} N={n} thr={thr} max_output={max_out}: idx/valid equal "
          f"({int(kv.sum())} kept); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events); "
          f"{share(bound[0], ms)} ({bound[1]}) [{card_name}]")
    _add(rec, 0.0, ms, plain_ms, bound)


def check_nms(dev, rng, card_name: str) -> dict:
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    rec = _record()
    for b, n, thr, max_out, classes in kb.NMS_CASES:
        boxes, scores = (torch.from_numpy(a).to(dev) for a in kb.nms_case(rng, b, n, classes))
        nms_against_plain(rec, boxes, scores, max_out, thr, "class-offset" if classes else "seeded", card_name)
    return rec


def roi_align_against_plain(rec: dict, lv, boxes, image: int, pool: int, label: str, card_name: str) -> None:
    """The forward kernel within 1 bf16 ulp of its plain version (f32
    levels: within 1e-5 of the element's absolute-contribution sum, as the
    backward's f32 check), then timed; its bound counts the level pixels
    these boxes' taps touch."""
    import torch

    from caesar_mrcnn_tpu_torch.ops import roi_align as R

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    b, n = boxes.shape[:2]
    c = lv[0].shape[-1]

    def kernel():
        return R.roi_align(lv, boxes, (image, image), pool)

    def plain():
        return R.roi_align_plain(lv, boxes, (image, image), pool)

    k, p = kernel(), plain()
    torch.cuda.synchronize()
    diff = (k.float() - p.float()).abs()
    if lv[0].dtype == torch.float32:
        name, held = "f32", "within 1e-5 of the absolute-contribution sum"
        tol = 1e-5 * R.roi_align_plain([f.abs() for f in lv], boxes, (image, image), pool)
    else:
        name, held = "bf16", "within 1 bf16 ulp"
        tol = bf16_ulp(torch.maximum(k.float().abs(), p.float().abs()))
    if not bool((diff <= tol).all()):
        raise AssertionError(f"roi_align {label} {name} {image}^2 N={n} pool={pool}: not {held}, "
                             f"max abs {float(diff.max())}")
    err = float(diff.max())
    ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 5)
    bound = kb.roi_align_bound(boxes, [tuple(f.shape[1:3]) for f in lv], (image, image), pool, c,
                               lv[0].element_size())
    print(f"kernels: roi_align {label} {name} {image}^2 B={b} N={n} pool={pool} C={c}: {held} "
          f"(max abs {err:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events); "
          f"{share(bound[0], ms)} ({bound[1]}) [{card_name}]")
    _add(rec, err, ms, plain_ms, bound)


def check_roi_align(dev, rng, card_name: str) -> dict:
    """The forward kernel at the detect and train paths' shapes, on seeded
    boxes of every size (``kernel_bench.FORWARD_CASES``)."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    rec = _record()
    levels = {}
    for image, n, pool in kb.FORWARD_CASES:
        if image not in levels:
            levels[image] = kb.pyramid(rng, dev, 8, image, 256)
        boxes = torch.from_numpy(kb.roi_case(rng, 8, n)).to(dev)
        roi_align_against_plain(rec, levels[image], boxes, image, pool, "seeded", card_name)
    return rec


def backward_against_plain(rec: dict, grad, boxes, label: str, card_name: str) -> None:
    """The backward kernel against the f64 plain gradient at the training
    pyramid (256^2: 64..8). Tolerance, per element: f32 within 1e-5 of the
    element's absolute-contribution sum (atomics sum in any order); bf16
    within 2 bf16 ulp of the f64 value plus that f32 term (the kernel sums
    in f32 and rounds once)."""
    import torch

    from caesar_mrcnn_tpu_torch.ops import roi_align as R

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    shapes = kb.TRAIN_LEVELS
    b, n, pool, _, c = grad.shape

    def kernel():
        return R.roi_align_backward(grad, boxes, shapes, (256, 256))

    def plain():
        return R.roi_align_backward_plain(grad, boxes, shapes, (256, 256))

    got = kernel()
    ref = R.roi_align_backward_plain(grad.double(), boxes, shapes, (256, 256))
    mag = R.roi_align_backward_plain(grad.double().abs(), boxes, shapes, (256, 256))
    torch.cuda.synchronize()
    err = 0.0
    for lvl, (g, r, m) in enumerate(zip(got, ref, mag)):
        diff = (g.double() - r).abs()
        tol = 1e-5 * m
        if grad.dtype == torch.bfloat16:
            tol = tol + 2 * bf16_ulp(r.abs().float()).double()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"roi_align_backward {label} {grad.dtype} N={n} pool={pool} P{lvl + 2}: "
                                 f"max abs diff {float(diff.max())}")
        err = max(err, float(diff.max()))
    ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 3)
    bound = kb.roi_align_backward_bound(b, shapes, n, pool, c, grad.element_size())
    name = "bf16" if grad.dtype == torch.bfloat16 else "f32"
    print(f"kernels: roi_align_backward {label} {name} B={b} N={n} pool={pool} C={c}: within tolerance of "
          f"the f64 plain gradient (max abs {err:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(median, CUDA events); {share(bound[0], ms)} ({bound[1]}) [{card_name}]")
    _add(rec, err, ms, plain_ms, bound)


def check_roi_align_backward(dev, rng, card_name: str) -> dict:
    """The backward kernel at the two training shapes, bf16 and f32, on
    seeded boxes of every size."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    rec = _record()
    for b, n, pool, c in kb.BACKWARD_CASES:
        boxes = torch.from_numpy(kb.roi_case(rng, b, n)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            grad = torch.from_numpy(rng.randn(b, n, pool, pool, c).astype(np.float32)).to(dev, dtype)
            backward_against_plain(rec, grad, boxes, "seeded", card_name)
    return rec


def crop_against_plain(rec: dict, masks, boxes, assign, crop, label: str, card_name: str) -> None:
    """crop_and_resize bit-equal to its plain version, then timed; its
    bound counts the mask sectors these boxes' taps touch."""
    import torch

    from caesar_mrcnn_tpu_torch.ops import roi_align as R

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    def kernel():
        return R.crop_and_resize(masks, boxes, assign, crop)

    def plain():
        return R.crop_and_resize_plain(masks, boxes, assign, crop)

    k, p = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"crop_and_resize {label}: {int((k != p).sum())} values differ from the plain "
                             f"version, max abs {float((k - p).abs().max())}")
    ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 5)
    bound = kb.crop_and_resize_bound(masks.shape, boxes, assign, crop)
    print(f"kernels: crop_and_resize {label} f32 masks {list(masks.shape)} R={assign.shape[1]} "
          f"{crop[0]}x{crop[1]} ({assign.dtype}): bit-equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(median, CUDA events); {share(bound[0], ms)} ({bound[1]}) [{card_name}]")
    _add(rec, 0.0, ms, plain_ms, bound)


def check_crop_and_resize(dev, rng, card_name: str) -> dict:
    """crop_and_resize at the training flagship's shapes (f32 masks
    [8, 256, 256, 300], 168 positive ROIs), on seeded boxes."""
    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    b, h, g, r, crop = kb.CROP_CASE
    rec = _record()
    crop_against_plain(rec, *kb.crop_case(rng, dev, b, h, g, r), (crop, crop), "seeded", card_name)
    return rec


def serving_config(**overrides):
    """The serving flagship with the CLI's ``--serving`` preset: the int8
    graph and the 3000 / 512 proposal budget."""
    kw = dict(quant_mode="int8", pre_nms_limit=3000, post_nms_rois_inference=512)
    kw.update(overrides)
    return flagship_config(**kw)


def _int_mm_applies(site) -> bool:
    """One matrix product computes the site's int32 sums: a 1x1 stride-1
    conv, or a VALID conv whose window covers its input."""
    return site.k == 1 and site.stride == 1 or site.k == site.h == site.w and site.pads == ((0, 0), (0, 0))


def check_conv_int8(dev, card_name: str):
    """The int8 convolution at seven sites of the serving flagship
    (``kernel_bench.CONV_INT8_SITES``) and at one site that requantizes
    for the next (``CONV_INT8_FUSED_SITE``), on seeded int8 inputs and
    weights over the whole range and seeded f32 scales and biases. The
    Hopper kernel, on its operands as ``hopper_operands`` readies them (the
    stem's input and weights padded to 16 channels, as the int8 graph runs
    it), against the plain versions: int32 sums equal to the plain version's
    (f64 sums, exact), f32 outputs bit-equal (the same product, then the
    same sum), and at the fused site the int8 output bit-equal to
    ``quantize_int8_plain`` of the plain f32 output. The kernel timed, in
    turns with the unfused pair at the fused site, the plain version apart,
    with ``torch._int_mm`` where one matrix product computes the same int32
    sums (the library yardstick) and the bf16 cuDNN convolution the float
    graph runs at the site (context only: another function)."""
    import torch
    import torch.nn.functional as F

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.ops import library as L
    from caesar_mrcnn_tpu_torch.ops import quant as Q

    rec = _record()
    library = {"ms": 0.0, "kernel_ms": 0.0, "sites": []}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sites = {site.name: site for site in kb.int8_sites(serving_config(), 512, 100)}
    for name in kb.CONV_INT8_SITES + (kb.CONV_INT8_FUSED_SITE,):
        site = sites[name]
        fused = name == kb.CONV_INT8_FUSED_SITE
        x = torch.randint(-127, 128, (site.batch, site.h, site.w, site.cin), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (site.cout, site.k, site.k, site.cin), generator=gen, device=dev,
                          dtype=torch.int8)
        sw = torch.rand(site.cout, generator=gen, device=dev) * 1e-3 + 1e-6
        b = torch.rand(site.cout, generator=gen, device=dev) * 2 - 1
        # the kernel's operands: the stem's 3 channels padded to 16, as the int8 graph runs it
        xh, wh = Q.hopper_operands(x, w)
        cin = xh.shape[-1]
        plan = Q.conv_plan(site.m, site.cout, site.k * site.k * cin,
                           sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        s_next = 0.0173 if fused else None

        def hopper():
            return Q.conv2d_int8(xh, wh, sw, b, site.stride, site.pads, site.relu, s_next)

        def plain():
            return Q.conv2d_int8_plain(x, w, sw, b, site.stride, site.pads, site.relu, s_next)

        acc_plain = Q.conv2d_int8_accumulate_plain(x, w, site.stride, site.pads)
        launched = dict(Q.conv2d_int8.route_launches)
        acc, out = Q.conv2d_int8_accumulate(xh, wh, site.stride, site.pads), hopper()
        if Q.conv2d_int8.route_launches != {"wgmma": launched["wgmma"] + 2}:
            raise AssertionError(f"conv2d_int8 {name}: launches {Q.conv2d_int8.route_launches}, before {launched}")
        out_plain = plain()
        torch.cuda.synchronize()
        if not torch.equal(acc, acc_plain):
            raise AssertionError(f"conv2d_int8 {name}: {int((acc != acc_plain).sum())} int32 sums differ")
        same = torch.equal(out, out_plain) if fused else torch.equal(out.view(torch.int32), out_plain.view(torch.int32))
        if not same:
            raise AssertionError(f"conv2d_int8 {name}: {int((out != out_plain).sum())} outputs differ")
        del acc, out, out_plain
        def unfused():  # the pair the fused call replaces: f32 out, then the quantizer pass
            return Q.quantize_int8(Q.conv2d_int8(xh, wh, sw, b, site.stride, site.pads, site.relu), s_next)

        # the kernel in turns with the unfused pair; the plain version apart (its f64 convolution runs for up to
        # 22 ms at full power and slows whatever follows it)
        ms, *unfused_ms = kb.median_ms_turns([hopper] + ([unfused] if fused else []), kb.REPS)
        plain_ms = kb.median_ms(plain, 3)
        bound = kb.conv_int8_bound(site if fused else site._replace(then=None))
        lib = ""
        if _int_mm_applies(site):
            a2, w2 = x.view(site.m, site.kdim), w.view(site.cout, site.kdim).t()

            def int_mm():
                return torch._int_mm(a2, w2)

            if not torch.equal(int_mm(), acc_plain.view(site.m, -1)):
                raise AssertionError(f"conv2d_int8 {name}: torch._int_mm's sums differ from the plain version's")
            lib_ms = kb.median_ms(int_mm, kb.REPS)
            library["ms"] += lib_ms
            library["kernel_ms"] += ms
            library["sites"].append(name)
            lib = f"torch._int_mm {lib_ms:.4f} ms (int32 sums only); "
        del acc_plain
        xf = torch.randn(site.batch, site.cin, site.h, site.w, generator=gen, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        wf = torch.randn(site.cout, site.cin, site.k, site.k, generator=gen, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        (pt, pb), (pl, pr) = site.pads
        padding = (pt, pl) if (pt, pl) == (pb, pr) else 0
        cudnn_ms = kb.median_ms(lambda: F.conv2d(xf, wf, stride=site.stride, padding=padding), kb.REPS)
        what = (f"requantized for {site.then} at s_next {s_next} (int8 out) bit-equal to quantize_int8_plain of the "
                f"plain f32" if fused else "f32 bit-equal")
        extra = ""
        if name == "fpn/c5p5":  # the host's share: wrapper calls enqueued back to back (split-K: a scratch tile too)
            def direct():  # the wrapper's checks, then the CUDA implementation: the call without the dispatcher
                Q._check_conv(xh, wh, site.stride, site.pads, sw, b)
                return L._conv2d_int8_cuda(xh, wh, sw, b, site.stride, Q._flat(site.pads), site.relu, s_next)

            host = {}
            for label, fn in (("Hopper", hopper), ("direct", direct), ("Hopper again", hopper),
                              ("direct again", direct)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(200):
                    fn()
                host[label] = (time.perf_counter() - t) / 200 * 1e3
                torch.cuda.synchronize()
            extra = (f"; host time per wrapper call through torch.ops.caesar.conv2d_int8 (200 enqueued, host clock): "
                     f"{host['Hopper']:.4f} / {host['Hopper again']:.4f} ms; the wrapper's checks and the CUDA "
                     f"implementation without the dispatcher {host['direct']:.4f} / {host['direct again']:.4f} ms")
        if fused:
            extra += f"; the unfused pair (f32 conv, then quantize_int8) {unfused_ms[0]:.4f} ms"
        print(f"kernels: conv2d_int8 {name} {site.k}x{site.k}/{site.stride} [{site.batch},{site.h},{site.w},"
              f"{site.cin}] -> {site.cout}, M={site.m} K={site.kdim} N={site.cout}: int32 sums equal, {what}; "
              f"Hopper kernel (bn {plan.bn}, split {plan.splits}, Cin {cin}) {ms:.4f} ms "
              f"({site.ops / ms / 1e9:.1f} TOPS; median, CUDA events), plain {plain_ms:.3f} ms{extra}; "
              f"{share(bound[0], ms)} ({bound[1]}); "
              f"{lib or 'no PyTorch int8 call; '}cuDNN bf16 conv of the float graph {cudnn_ms:.4f} ms (context) "
              f"[{card_name}]")
        _add(rec, 0.0, ms, plain_ms, bound)
        del x, w, xh, wh, xf, wf
    torch.cuda.empty_cache()
    return rec, library


def check_quantize_int8(dev, rng, card_name: str) -> dict:
    """The quantizer bit-equal to its plain version at the serving graph's
    inputs (the stem's f32 image batch, written with its 3 channels padded
    to 16 as the int8 graph runs it, against the plain version padded with
    zeros; the RPN's bf16 P2, a mask-head f32 activation) and on exact .5
    ties (a power-of-two scale), f32 and bf16."""
    import torch
    import torch.nn.functional as F

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.ops import quant as Q

    rec = _record()
    ties = torch.from_numpy((rng.randint(-140, 140, 1 << 22) + 0.5).astype(np.float32) * 0.25).to(dev)
    cases = [  # (label, input, scale, channels written)
        ("stem input f32 [8,512,512,3] -> int8 [8,512,512,16]", torch.rand(8, 512, 512, 3, device=dev) * 255,
         255 / 127, 16),
        ("rpn/shared@p2 input bf16 [8,128,128,256]",
         torch.randn(8, 128, 128, 256, device=dev).to(torch.bfloat16), 4.5 / 127, None),
        ("mask/conv2 input f32 [800,14,14,256]", torch.randn(800, 14, 14, 256, device=dev).relu_(), 4.0 / 127,
         None),
        ("ties f32 [4M]", ties, 0.25, None),
        ("ties bf16 [4M]", ties.to(torch.bfloat16), 0.25, None),
    ]
    for label, x, s_in, channels in cases:
        def kernel():
            return Q.quantize_int8(x, s_in, channels)

        def plain():
            q = Q.quantize_int8_plain(x, s_in)
            return q if channels is None else F.pad(q, (0, channels - x.shape[-1]))

        k, p = kernel(), plain()
        torch.cuda.synchronize()
        if k.shape != p.shape or not torch.equal(k, p):
            raise AssertionError(f"quantize_int8 {label}: {k.shape} against {p.shape}, "
                                 f"{int((k != p).sum()) if k.shape == p.shape else 'all'} values differ from the "
                                 f"plain version")
        ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 5)
        bound = kb.quantize_bound(x.numel(), x.element_size(), k.numel())
        print(f"kernels: quantize_int8 {label} s_in {s_in:.6g}: bit-equal; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median, CUDA events); {share(bound[0], ms)} ({bound[1]}) [{card_name}]")
        _add(rec, 0.0, ms, plain_ms, bound)
    return rec


def check_fold_conv_bn(dev, card_name: str) -> dict:
    """The fold of the flagship detector's own (conv, batch norm) pairs
    (ResNet-101's 104, the mask head's 4; batch norms and biases seeded off
    their defaults), to bf16 (the path's) and f32, bit-equal to the plain
    version on the CPU, then timed: the wrapper's call (CUDA events) and
    the kernel alone (profiler). Bound by bytes: 4 read and 2 (bf16) or 4
    written a weight, plus the vectors."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.models import layers
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.ops import fold as Fo

    model = MaskRCNN(flagship_config())
    randomize_affine(model)
    model.to(dev)
    rec = _record()
    for part, m in (("backbone", model.backbone), ("mask head", model.mask_head)):
        convs, bns = zip(*m.conv_bn_pairs())
        args = ([c.weight.detach() for c in convs], [c.bias.detach() for c in convs],
                [b.scale.detach() for b in bns], [b.bias.detach() for b in bns], [b.mean for b in bns],
                [b.var for b in bns])
        cpu = [[t.cpu() for t in a] for a in args]
        n_w, n_c = sum(w.numel() for w in args[0]), sum(w.shape[0] for w in args[0])
        for dtype in (torch.bfloat16, torch.float32):
            def kernel():
                return Fo.fold_conv_bn(*args, layers.BN_EPS, dtype)

            def plain():
                return Fo.fold_conv_bn_plain(*args, layers.BN_EPS, dtype)

            before = Fo.fold_conv_bn.launches
            got = kernel()
            torch.cuda.synchronize()
            if Fo.fold_conv_bn.launches != before + 1:
                raise AssertionError(f"fold_conv_bn {part}: {Fo.fold_conv_bn.launches - before} launches, expected 1")
            want = Fo.fold_conv_bn(*cpu, layers.BN_EPS, dtype)
            bad = sum(int((g.cpu() != w).sum()) for gw, w_ in zip(got, want) for g, w in zip(gw, w_))
            if bad:
                raise AssertionError(f"fold_conv_bn {part} to {dtype}: {bad} values differ from the plain version")
            ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 5)
            alone = sum(t for k, (t, _) in kb.device_split(kernel, kb.REPS).items() if "fold_conv_bn_kernel" in k)
            bound = kb.fold_bound(n_w, n_c, torch.empty(0, dtype=dtype).element_size())
            print(f"kernels: fold_conv_bn {part} {len(convs)} pairs, {n_w} weights, to {str(dtype)[6:]}: bit-equal; "
                  f"call {ms:.4f} ms, kernel alone {alone:.4f} ms (profiler), plain {plain_ms:.4f} ms (median, "
                  f"CUDA events); {share(bound[0], ms)}, kernel alone {bound[0] / alone:.3f} ({bound[1]}) "
                  f"[{card_name}]")
            if dtype == torch.bfloat16:  # the path's
                _add(rec, 0.0, ms, plain_ms, bound)
    del model
    torch.cuda.empty_cache()
    return rec


# -------------------------------------------------------------------- slice
# -------------------------------------------------------------------- slice


def write_mosaic(path: str, n: int = 2048, seed: int = SEED) -> None:
    """Radio-looking n x n FITS mosaic: noise plus gaussian sources."""
    from caesar_mrcnn_tpu_torch.utils.fits import write_fits

    rng = np.random.RandomState(seed)
    img = rng.normal(0.0, 0.05, (n, n)).astype(np.float32)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    for _ in range(n // 16):
        cy, cx = rng.randint(32, n - 32, 2)
        s = rng.uniform(2.0, 8.0)
        amp = rng.uniform(0.5, 20.0)
        img[cy - 32:cy + 32, cx - 32:cx + 32] += amp * np.exp(
            -(((yy - 32) ** 2 + (xx - 32) ** 2) / (2 * s * s))
        )
    write_fits(img, path, header={"BMAJ": 1.5e-3, "BMIN": 1.2e-3,
                                  "CDELT1": -2.8e-4, "CDELT2": 2.8e-4})


def read_tiles(path: str, n: int, size: int) -> np.ndarray:
    from caesar_mrcnn_tpu_torch.utils.fits import read_tile_u8
    from caesar_mrcnn_tpu_torch.utils.tiles import generate_tiles

    tiles = [read_tile_u8(path, x1, x2, y1, y2)
             for x1, x2, y1, y2 in generate_tiles(0, n, 0, n, size, size)]
    return np.stack(tiles)


def run_pass(det, tiles: np.ndarray, depth: int = 2):
    """dispatch/collect over all tiles with ``depth`` batches in flight."""
    bs = det.config.batch_size
    handles, results = [], []
    for s in range(0, len(tiles), bs):
        handles.append(det.dispatch_tiles(tiles[s:s + bs]))
        if len(handles) >= depth:
            results += det.collect(handles.pop(0))
    for h in handles:
        results += det.collect(h)
    return results


def check_slice(card_name: str) -> tuple:
    import torch

    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.ops.fold import fold_conv_bn
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.paste import paste_masks
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_mosaic(path)
        t = time.perf_counter()
        tiles = read_tiles(path, 2048, 512)
        read_s = time.perf_counter() - t
    cfg = flagship_config()
    det = build_detector(cfg, seed=SEED, device="cuda")
    settle_random_weights(det.model)
    batches = len(tiles) // cfg.batch_size

    torch.cuda.reset_peak_memory_stats()
    nms_padded.launches = roi_align.launches = paste_masks.launches = fold_conv_bn.launches = 0
    results = run_pass(det, tiles)
    launches = {"nms": nms_padded.launches, "roi_align": roi_align.launches, "paste_masks": paste_masks.launches,
                "fold_conv_bn": fold_conv_bn.launches}
    # the fold: the backbone's in the features graph's warm-up pass and in its capture (a replay launches it
    # without Python), the mask head's once a batch
    if launches != {"nms": 2 * batches, "roi_align": 2 * batches, "paste_masks": batches,
                    "fold_conv_bn": 2 + batches}:
        raise AssertionError(f"kernel launches on the main path {launches}, expected 2, 2, 1 and 1 per batch x "
                             f"{batches}, and 2 fold_conv_bn at the capture")
    for r in results:
        n = len(r["class_ids"])
        if r["masks"].shape != (512, 512, n) or r["rois"].shape != (n, 4):
            raise AssertionError(f"result shapes {r['rois'].shape} {r['masks'].shape}")
        if not (np.isfinite(r["scores"]).all() and ((r["scores"] >= 0) & (r["scores"] <= 1)).all()):
            raise AssertionError("non-finite or out-of-range scores")
        if not ((r["rois"] >= 0).all() and (r["rois"] <= 512).all()):
            raise AssertionError("boxes outside the tile")
    counts = [len(r["class_ids"]) for r in results]
    if len(results) != len(tiles) or sum(counts) == 0:
        raise AssertionError(f"{len(results)} results, detections per tile {counts}")

    fold_conv_bn.launches = 0
    run_pass(det, tiles)  # steady state
    if fold_conv_bn.launches != batches:
        raise AssertionError(f"fold_conv_bn launches after the capture {fold_conv_bn.launches}, expected 1 per batch "
                             f"x {batches} (the mask head's)")
    torch.cuda.synchronize()
    t = time.perf_counter()
    run_pass(det, tiles)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: {len(tiles)} tiles of 512^2 from a 2048^2 FITS mosaic (read+zscale {read_s:.2f} s on the host), "
          f"ResNet-101 batch 8 bf16, launches {launches}; detections per tile {counts} [{card_name}]")
    print(f"slice: timed third pass {len(tiles) / dt:.2f} img/s (dispatch/collect with unmold, tiles pre-read), "
          f"peak device memory {peak / 2**30:.2f} GiB [{card_name}]")
    detections, masks = det.fetch(det.dispatch_tiles(tiles[:cfg.batch_size]))[:2]
    return launches, (detections, masks)


def paste_against_plain(rec: dict, detections, masks, where: str, label: str, card_name: str) -> None:
    """The paste kernel's frames (``where``: pinned host memory, as the
    detect path writes them, or the device) bit-equal to the plain
    version's, then timed; its bound, the kept frames' bytes written once,
    over PCIe into pinned memory or over HBM into device memory."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.ops import paste as P

    b, d = detections.shape[:2]
    shape = (512, 512)
    hw = shape[0] * shape[1]
    size = hw * d
    cuda_dets, cuda_masks = torch.from_numpy(detections).cuda(), torch.from_numpy(masks).cuda()
    frames = [torch.empty(size, dtype=torch.bool, pin_memory=True) if where == "pinned"
              else torch.empty(size, dtype=torch.bool, device="cuda") for _ in range(b)]
    ref = [torch.empty(size, dtype=torch.bool) for _ in range(b)]
    cpu_dets, cpu_masks = torch.from_numpy(detections), torch.from_numpy(masks)

    def kernel():
        P.paste_masks(cuda_dets, cuda_masks, frames, shape)

    def plain():
        P.paste_masks(cpu_dets, cpu_masks, ref, shape)

    kernel()
    plain()
    torch.cuda.synchronize()
    kept = [P.kept_boxes(tile, shape)[1] for tile in detections]
    n = sum(len(boxes) for boxes in kept)
    bad = sum(int((frames[t][:len(k) * hw].cpu() != ref[t][:len(k) * hw]).sum()) for t, k in enumerate(kept))
    if bad:
        raise AssertionError(f"paste_masks {label}, {where} frames: {bad} frame bytes differ from the plain version")
    ms = kb.median_ms(kernel, kb.REPS)
    host = []
    for _ in range(3):
        t = time.perf_counter()
        plain()
        host.append(1e3 * (time.perf_counter() - t))
    plain_ms = statistics.median(host)
    nbytes = n * hw
    bound = (1e3 * nbytes / (PCIE_BYTES_PER_S if where == "pinned" else kb.PEAK_BYTES_PER_S), "bytes")
    area = statistics.mean(float(((k[:, 2] - k[:, 0]) * (k[:, 3] - k[:, 1])).mean()) / hw for k in kept if len(k))
    print(f"kernels: paste_masks {label} B={b} {shape[0]}^2 D={d}, {n} kept (mean box {100 * area:.2f}% of the "
          f"tile), frames in {'pinned host' if where == 'pinned' else 'device'} memory: bit-equal; kernel {ms:.3f} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s of frames), plain {plain_ms:.1f} ms (median of 3, the CPU); "
          f"{share(bound[0], ms)} (bytes over {'PCIe 5.0 x16' if where == 'pinned' else 'HBM'}) [{card_name}]")
    _add(rec, 0.0, ms, plain_ms, bound)


def check_paste_masks(rng, path_batch, card_name: str) -> dict:
    """The masks' paste at the tiled detect path's shape (8 tiles of 512^2,
    100 detections a tile): a batch of the slice's own detections, seeded
    boxes up to the whole tile, and every detection's box the whole tile,
    each into pinned and device frames."""
    from caesar_mrcnn_tpu_torch.testing import paste_inputs

    rec = _record()
    seeded = paste_inputs(rng, 8, 100, (512, 512))
    whole = seeded[0].copy()
    whole[..., :4] = (0.0, 0.0, 1.0, 1.0)
    whole[..., 4] = 1.0
    for label, (detections, masks) in (("slice batch", path_batch), ("seeded wide boxes", seeded),
                                       ("tile-wide boxes", (whole, seeded[1]))):
        for where in ("pinned", "device"):
            paste_against_plain(rec, detections, masks, where, label, card_name)
    return rec


def check_parity(card_name: str) -> None:
    import torch

    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.testing import compare_detections

    cfg = flagship_config(images_per_device=1, compute_dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_mosaic(path)
        tile = read_tiles(path, 2048, 512)[5:6]
    outs = []
    for device in ("cuda", "cpu"):
        det = build_detector(cfg, seed=SEED, device=device)
        settle_random_weights(det.model)
        fetched = det.fetch(det.dispatch_tiles(tile))
        det_raw = fetched[0][0]
        keep = det_raw[:, 4] > 0
        raw = {"scores": det_raw[keep, 5], "class_ids": det_raw[keep, 4], "boxes": det_raw[keep, :4]}
        outs.append((raw, det.unmold_fetched(fetched)[0]))
    (g_raw, g_res), (c_raw, c_res) = outs
    raw = compare_detections(c_raw, g_raw)
    res = compare_detections(c_res, g_res)
    print(f"parity: one f32 tile, card vs CPU: {len(c_res['scores'])} / {len(g_res['scores'])} detections, "
          f"{raw['compared']} isolated compared, {raw['unmatched']} unmatched; max box diff "
          f"{raw['max_boxes_diff']:.3g}, max score diff {raw['max_scores_diff']:.3g}, "
          f"{res['mask_pixels_differ']} mask pixels differ [{card_name}]")
    if raw["compared"] == 0 or raw["unmatched"] or raw["class_mismatch"] or res["class_mismatch"]:
        raise AssertionError(f"card/CPU detections differ: {raw} {res}")
    if raw["max_boxes_diff"] > 1e-4 or raw["max_scores_diff"] > 1e-5:
        raise AssertionError(f"card/CPU differences beyond 1e-4 (boxes) / 1e-5 (scores): {raw}")
    if res["max_rois_diff"] > 0 or res["mask_pixels_differ"]:
        raise AssertionError(f"unmolded card/CPU results differ: {res}")


# ------------------------------------------------------------------ catalog


class TimedDetector:
    """The detector as SFinder sees it, with the wall seconds of its calls:
    ``dispatch`` (H2D copy and enqueue), ``wait`` (until the batch's
    results are on the host) and ``unmold`` (host unmold, ``collect``'s
    other half)."""

    def __init__(self, det):
        self.det = det
        self.config = det.config
        self.seconds = {"dispatch": 0.0, "wait": 0.0, "unmold": 0.0}

    def _timed(self, span: str, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.seconds[span] += time.perf_counter() - t

    def dispatch_tiles(self, tiles):
        return self._timed("dispatch", self.det.dispatch_tiles, tiles)

    def collect(self, handle):
        return self._timed("unmold", self.det.unmold_fetched, self._timed("wait", self.det.fetch, handle))

    def detect(self, images):
        return self._timed("wait", self.det.detect, images)


class MethodTimer:
    """Functions wrapped where the code looks them up (an attribute of a
    class, an instance or a module) for one run: each call's wall ms, by
    name."""

    def __init__(self, targets: dict):
        self.targets = targets  # name -> (owner, attribute)
        self.ms = {name: [] for name in targets}
        self.saved = {}

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = self.saved[name] = getattr(owner, attr)

            def timed(*args, _fn=fn, _ms=self.ms[name], **kwargs):
                t = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    _ms.append(1e3 * (time.perf_counter() - t))

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self.saved[name])


# SFinder's own host work, by step: per-tile analysis (``_tile_sources``:
# Analyzer masks, contours, catalog entries), the cross-tile merge, the
# source parameters (FITS re-read, moments, WCS) and writing the catalog
# and DS9 files
SFINDER_SPANS = ("_tile_sources", "_merge_edge_sources", "_add_source_params", "save")


def run_catalog(det, cfg, path: str, out: str):
    """SFinder.run_tiled on ``path``, the catalog and DS9 file written to
    ``out``.json / ``out``.reg: (sources, catalog read back, DS9 text,
    wall seconds, host spans)."""
    from caesar_mrcnn_tpu_torch.analysis.sfinder import SFinder

    sf = SFinder(det, cfg)
    sf.outfile_json, sf.outfile_ds9 = f"{out}.json", f"{out}.reg"
    with MethodTimer({name: (sf, name) for name in SFINDER_SPANS}) as timer:
        t = time.perf_counter()
        sources = sf.run_tiled(path)
        wall = time.perf_counter() - t
    spans = {name: sum(ms) / 1e3 for name, ms in timer.ms.items()}
    with open(sf.outfile_json) as f:
        catalog = json.load(f)
    with open(sf.outfile_ds9) as f:
        regions = f.read()
    return sources, catalog, regions, wall, spans


def check_catalog_files(sources: dict, catalog: dict, regions: str, nx: int, ny: int) -> int:
    """The catalog read back equals what run_tiled returned (names, boxes,
    pixel counts), every source's box lies in the mosaic, and the DS9 file
    holds one polygon per source border of 3 points or more (``vertexes``),
    named after its source. Returns the sources without a polygon (1 or 2
    pixels)."""
    objs = catalog["objs"]
    if not objs:
        raise AssertionError("empty catalog")
    back = [(o["name"], o["x1"], o["x2"], o["y1"], o["y2"], len(o["pixels"])) for o in objs]
    ran = [(o["name"], o["x1"], o["x2"], o["y1"], o["y2"], len(o["pixels"])) for o in sources["objs"]]
    if back != ran:
        raise AssertionError("the catalog read back differs from run_tiled's sources")
    outside = [o["name"] for o in objs if not (0 <= o["x1"] <= o["x2"] <= nx and 0 <= o["y1"] <= o["y2"] <= ny)]
    if outside:
        raise AssertionError(f"sources with a box outside the {nx} x {ny} mosaic: {outside[:10]}")
    lines = [line for line in regions.splitlines() if line.startswith("polygon(")]
    named = sorted(line.split("text={", 1)[1].split("}", 1)[0] for line in lines)
    expected = sorted(o["name"] for o in objs for _ in o["vertexes"])
    if named != expected:
        raise AssertionError(f"DS9 file: {len(lines)} polygons, expected {len(expected)} (one per border)")
    return sum(1 for o in objs if not o["vertexes"])


def check_catalog(card_name: str) -> dict:
    """SFinder.run_tiled on the card at the serving flagship's full width
    (settled random weights, every detection kept) over the seeded 2048^2
    mosaic (16 tiles of 512^2, steps 1.0): launches,
    the catalog's checks, then a second, timed run split into the
    detector's time and SFinder's own host work."""
    import torch

    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.paste import paste_masks
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align
    from caesar_mrcnn_tpu_torch.utils.tiles import generate_tiles

    # Keep every detection, whatever its random score: the host layer is
    # measured at the slice's 100 detections per tile
    cfg = flagship_config(score_thr=0.0)
    n = 2048
    tiles = len(generate_tiles(0, n, 0, n, cfg.tile_xsize, cfg.tile_ysize, cfg.tile_xstep, cfg.tile_ystep))
    batches = -(-tiles // cfg.batch_size)
    det = build_detector(cfg, seed=SEED, device="cuda")
    settle_random_weights(det.model)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_mosaic(path, n)
        torch.cuda.synchronize()
        nms_padded.launches = roi_align.launches = paste_masks.launches = 0
        sources, catalog, regions, _, _ = run_catalog(det, cfg, path, os.path.join(tmp, "catalog"))
        launches = {"nms": nms_padded.launches, "roi_align": roi_align.launches, "paste_masks": paste_masks.launches}
        if launches != {"nms": 2 * batches, "roi_align": 2 * batches, "paste_masks": batches}:
            raise AssertionError(f"catalog launches {launches}, expected 2, 2 and 1 per batch x {batches}")
        no_polygon = check_catalog_files(sources, catalog, regions, n, n)
        timed = TimedDetector(det)
        _, again, _, wall, spans = run_catalog(timed, cfg, path, os.path.join(tmp, "timed"))
    objs = catalog["objs"]
    merged = sum(bool(o.get("merged")) for o in objs)
    edge = sum(bool(o.get("edge")) for o in objs)
    scores = [o["score"] for o in objs]
    waited = sum(timed.seconds.values())
    print(f"catalog: SFinder.run_tiled, {tiles} tiles of 512^2 from the seeded {n}^2 FITS mosaic, ResNet-101 "
          f"batch 8 bf16, launches {launches}: {len(objs)} sources ({merged} merged across tiles, {edge} edge, "
          f"{no_polygon} without a DS9 polygon: under 3 border points; scores {min(scores):.3f}-"
          f"{max(scores):.3f}); catalog JSON and DS9 file read back [{card_name}]")
    print(f"catalog: timed second run {wall:.3f} s wall, {tiles / wall:.2f} tiles/s; detector "
          f"{waited:.3f} s ({waited / wall:.3f} of the wall: "
          + ", ".join(f"{k} {v:.3f}" for k, v in timed.seconds.items())
          + "); SFinder host: " + ", ".join(f"{k.strip('_')} {v:.3f}" for k, v in spans.items())
          + f" s; catalog {'equal to' if again == catalog else 'DIFFERENT from'} the first run's [{card_name}]")
    return launches


def write_blocks_mosaic(path: str, ny: int, nx: int, seed: int = SEED) -> None:
    """Seeded noise with two bright blocks: one inside the first tile, one
    straddling the x = 512 tile boundary."""
    from caesar_mrcnn_tpu_torch.utils.fits import write_fits

    rng = np.random.RandomState(seed)
    img = rng.normal(0.0, 0.05, (ny, nx)).astype(np.float32)
    img[100:160, 120:200] += 10.0
    img[300:380, 470:560] += 10.0
    write_fits(img, path, header={"BMAJ": 1.5e-3, "BMIN": 1.2e-3, "CDELT1": -2.8e-4, "CDELT2": 2.8e-4})


def check_catalog_parity(card_name: str) -> None:
    """SFinder.run_tiled through the serving flagship at f32 with pinned
    heads (``testing.pin_heads``), batch 4, on the card and on the CPU
    (the plain versions), over a seeded 1024^2 mosaic of 4 tiles: the two
    catalogs equal in sources, names, classes, boxes, pixels and
    ``vertexes``; scores within 1e-5; source parameters within 1e-6
    relative."""
    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.testing import catalog_differences, pin_heads

    cfg = flagship_config(images_per_device=4, compute_dtype="float32")
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_blocks_mosaic(path, 1024, 1024)
        for device in ("cuda", "cpu"):
            det = build_detector(cfg, seed=SEED, device=device)
            pin_heads(det.model)
            t = time.perf_counter()
            out[device] = run_catalog(det, cfg, path, os.path.join(tmp, device))[1]
            seconds[device] = time.perf_counter() - t
    card, cpu = out["cuda"], out["cpu"]
    diffs = catalog_differences(cpu, card, rtol=1e-6, score_atol=1e-5)
    objs = card["objs"]
    print(f"catalog parity: 4 tiles of 512^2 from a seeded 1024^2 mosaic, ResNet-101 f32 batch 4, heads pinned: "
          f"card {len(objs)} sources ({sum(bool(o.get('merged')) for o in objs)} merged), CPU {len(cpu['objs'])}; "
          f"{len(diffs)} differences (sources, names, classes, boxes, pixels, vertexes exactly; scores 1e-5; "
          f"pars 1e-6 relative); card {seconds['cuda']:.2f} s, CPU {seconds['cpu']:.2f} s [{card_name}]")
    if not objs or diffs:
        raise AssertionError("card and CPU catalogs differ:\n" + "\n".join(diffs[:20]))


# ------------------------------------------------------------------ serving


INT8_SITES = 123  # int8 convolutions per detect batch at ResNet-101
INT8_FUSED = 70  # of them requantizing for the next in their epilogue
INT8_QUANTIZERS = INT8_SITES - INT8_FUSED  # quantizer passes per batch
# the float graph's folded convolutions: ResNet-101's stem and its 33 blocks' three (the 4 projection shortcuts, folded
# too, run ATen's conv without bias), the mask head's four
FOLDED_CONVS = 1 + 3 * 33 + 4


def _int8_counters():
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.quant import conv2d_int8, quantize_int8
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align

    return {"nms": nms_padded, "roi_align": roi_align, "conv2d_int8": conv2d_int8, "quantize_int8": quantize_int8}


def _premold(det, tiles: np.ndarray):
    """A tile batch as ``dispatch_tiles`` molds it on the device, with the
    batch's anchors and metas."""
    import torch

    h, w, c = det.config.image_shape
    x = torch.from_numpy(tiles).to(det.device).float()[..., None].expand(-1, -1, -1, c) - det._mean
    anchors, metas = det._constants((h, w, c))
    return x.contiguous(), metas[:len(tiles)], anchors


def check_serving(card_name: str):
    """The int8 serving graph at the serving flagship's width on the card,
    through ``dispatch_tiles``/``collect`` (module docstring, phase 10).
    Returns the first pass's launches and ``conv2d_int8.route_launches``."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.inference.detector import Detector, build_detector
    from caesar_mrcnn_tpu_torch.models import heads_int8 as Q
    from caesar_mrcnn_tpu_torch import weights as W

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_mosaic(path)
        tiles = read_tiles(path, 2048, 512)
    cfg = serving_config()
    det = build_detector(cfg, seed=SEED, device="cuda")
    settle_random_weights(det.model)
    batches = len(tiles) // cfg.batch_size
    calibration = []
    quantize_molded = det._quantize_molded

    def timed_calibration(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        quantize_molded(*args)
        torch.cuda.synchronize()
        calibration.append(time.perf_counter() - t)

    det._quantize_molded = timed_calibration
    counters = _int8_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv = counters["conv2d_int8"]
    for k in counters.values():
        k.launches = 0
    conv.route_launches = {"wgmma": 0}
    results = run_pass(det, tiles)
    launches = {name: k.launches for name, k in counters.items()}
    routes = dict(conv.route_launches)
    expected = {"nms": 2 * batches + 2, "roi_align": 2 * batches + 2, "conv2d_int8": INT8_SITES * batches,
                "quantize_int8": INT8_QUANTIZERS * batches}
    if launches != expected or len(calibration) != 1 or len(det.qtree) != INT8_SITES:
        raise AssertionError(f"serving launches {launches}, expected {expected} ({INT8_SITES} int8 convs and "
                             f"{INT8_QUANTIZERS} quantizer passes per batch, 2 NMS and 2 ROIAlign per batch and 2 "
                             f"of each for the calibration); {len(calibration)} calibrations, {len(det.qtree)} sites")
    if routes != {"wgmma": INT8_SITES * batches}:
        raise AssertionError(f"serving: conv2d_int8 {routes}: every one of the {INT8_SITES} sites of a batch "
                             f"must run the Hopper kernel")
    for r in results:
        n = len(r["class_ids"])
        if r["masks"].shape != (512, 512, n) or r["rois"].shape != (n, 4):
            raise AssertionError(f"serving result shapes {r['rois'].shape} {r['masks'].shape}")
        if not (np.isfinite(r["scores"]).all() and ((r["scores"] >= 0) & (r["scores"] <= 1)).all()):
            raise AssertionError("serving: non-finite or out-of-range scores")
    counts = [len(r["class_ids"]) for r in results]
    if len(results) != len(tiles) or sum(counts) == 0:
        raise AssertionError(f"serving: {len(results)} results, detections per tile {counts}")
    peak_first = torch.cuda.max_memory_allocated()
    run_pass(det, tiles)  # steady state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run_pass(det, tiles)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    print(f"serving: {len(tiles)} tiles of 512^2 from the seeded 2048^2 mosaic, ResNet-101 batch 8 int8 "
          f"(bf16 heads), 3000/512 proposals; calibration on the first batch {calibration[0]:.3f} s; launches over "
          f"the first pass {launches} ({INT8_SITES} conv2d_int8, all on the Hopper kernel {routes}, and "
          f"{INT8_QUANTIZERS} quantize_int8 per batch: {INT8_FUSED} quantizers run in convolution epilogues); "
          f"detections per tile {counts} [{card_name}]")

    x, metas, anchors = _premold(det, tiles[:cfg.batch_size])
    bf16 = Detector(flagship_config(pre_nms_limit=3000, post_nms_rois_inference=512), det.model, "cuda")
    steps = {name: kb.median_ms(lambda d=d: d._step(x, metas, anchors), 10)
             for name, d in (("int8", det), ("bf16", bf16), ("int8 again", det), ("bf16 again", bf16))}
    split = kb.device_split(lambda: det._step(x, metas, anchors), 3)
    own = {k: sum(ms for key, (ms, _) in split.items() if k in key) for k in ("conv_int8", "quantize_int8")}
    total = sum(ms for ms, _ in split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1][0])[:5]
    bf16_total = sum(ms for ms, _ in kb.device_split(lambda: bf16._step(x, metas, anchors), 3).values())
    sites = kb.int8_sites(cfg, cfg.post_nms_rois_inference, cfg.detection_max_instances)
    conv_bound = sum(kb.conv_int8_bound(s)[0] for s in sites)
    unfused_bound = sum(kb.conv_int8_bound(s._replace(then=None))[0] for s in sites)
    quant_bound = sum(kb.input_quantize_bound(s)[0] for s in sites if s.name not in {x.then for x in sites})
    print(f"serving: timed third pass {len(tiles) / dt:.2f} img/s (dispatch/collect with unmold, tiles pre-read); "
          f"detect step per batch of 8 (median of 10, CUDA events): int8 {steps['int8']:.2f} / "
          f"{steps['int8 again']:.2f} ms, bf16 graph on the same weights and tiles {steps['bf16']:.2f} / "
          f"{steps['bf16 again']:.2f} ms; peak device memory {peak_first / 2**30:.2f} GiB over the first pass "
          f"(the f32 calibration in it), {peak / 2**30:.2f} GiB over the timed pass [{card_name}]")
    print(f"serving: int8 step's device time {total:.2f} ms (profiler, per step; the bf16 graph's {bf16_total:.2f} "
          f"ms): convolution kernels {own['conv_int8']:.2f} ms (the {INT8_SITES} sites' summed bound "
          f"{conv_bound:.4f} ms with {INT8_FUSED} int8 outputs, {unfused_bound:.4f} ms with every output f32 as "
          f"before the fusion), quantizer kernels {own['quantize_int8']:.2f} ms ({INT8_QUANTIZERS} passes, their "
          f"bound {quant_bound:.4f} ms at their inputs' dtypes), the rest {total - sum(own.values()):.2f} ms; top: "
          + "; ".join(f"{k[:50]} {v[0]:.3f}" for k, v in top) + f" [{card_name}]")

    folded = Q.fold_detect(W.state_dict_to_flax(det.model.state_dict()), cfg)
    with torch.inference_mode(), Q.exact_f32():
        ref = Q.folded_stages(det.model, folded).features(x)
        got = det._stages.features(x)
        rel = [float((g.float() - r).norm() / r.norm()) for g, r in zip(got, ref)]
    print(f"serving: int8 pyramid P2..P6 against the folded f32 graph's, relative L2 "
          + ", ".join(f"{v:.4f}" for v in rel) + f" (bound 0.25) [{card_name}]")
    if not all(0 < v < 0.25 for v in rel):
        raise AssertionError(f"serving: int8 pyramid relative L2 {rel} outside (0, 0.25)")
    return launches, routes


def check_serving_parity(card_name: str) -> None:
    """One quantized tree, calibrated on the CPU (the plain versions) and
    carried to the card (``Detector.use_qtree``), at f32, 256^2, batch 2,
    heads pinned: the int8 pyramid of one tile batch on the card equal to
    the CPU's bit for bit (integer sums; the quantizer divides and the
    epilogue rounds its product and its sum on both; the rest of the
    backbone and FPN adds and takes maxima, exact in f32), and
    ``SFinder.run_tiled`` over a seeded 512^2 mosaic (4 tiles) giving the
    same catalog on both, as ``catalog parity:`` holds it."""
    import torch

    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.testing import catalog_differences, pin_heads

    cfg = serving_config(image_min_dim=256, image_max_dim=256, images_per_device=2, compute_dtype="float32",
                         tile_xsize=256, tile_ysize=256)
    dets = {}
    for device in ("cpu", "cuda"):
        dets[device] = build_detector(cfg, seed=SEED, device=device)
        settle_random_weights(dets[device].model)
        pin_heads(dets[device].model)
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_blocks_mosaic(path, 512, 512)
        tiles = read_tiles(path, 512, 256)[:2]
        for device in ("cpu", "cuda"):
            det = dets[device]
            if device == "cuda":
                det.use_qtree(dets["cpu"].qtree)
            t = time.perf_counter()
            out[device] = run_catalog(det, cfg, path, os.path.join(tmp, device))[1]
            seconds[device] = time.perf_counter() - t
    with torch.inference_mode():
        pyr = {device: [p.cpu() for p in det._stages.features(_premold(det, tiles)[0])]
               for device, det in dets.items()}
    same = [torch.equal(g.view(torch.int32), c.view(torch.int32)) for g, c in zip(pyr["cuda"], pyr["cpu"])]
    diffs = catalog_differences(out["cpu"], out["cuda"], rtol=1e-6, score_atol=1e-5)
    print(f"serving parity: one quantized tree ({len(dets['cpu'].qtree)} sites) calibrated on the CPU, used on the "
          f"card; ResNet-101 f32 int8 256^2 batch 2, heads pinned: int8 pyramid P2..P6 card = CPU bit for bit "
          f"{same}; catalog over 4 tiles of a seeded 512^2 mosaic: card {len(out['cuda']['objs'])} sources, CPU "
          f"{len(out['cpu']['objs'])}, {len(diffs)} differences; card {seconds['cuda']:.2f} s, CPU "
          f"{seconds['cpu']:.2f} s [{card_name}]")
    if not all(same):
        raise AssertionError(f"serving parity: the card's int8 pyramid differs from the CPU's: {same}")
    if not out["cuda"]["objs"] or diffs:
        raise AssertionError("serving parity: card and CPU catalogs differ:\n" + "\n".join(diffs[:20]))


# ------------------------------------------------------------------- export

# Run in a fresh process: load an exported artifact with ServingDetector (the
# model code is never imported), run the program once on the molded batch
# (launches counted), save its raw outputs, then detect on the 16 tiles.
EXPORT_SERVE = r"""
import json, sys, time
import numpy as np
import torch
from caesar_mrcnn_tpu_torch.inference.export import ServingDetector, caesar_nodes
from caesar_mrcnn_tpu_torch.ops import fold, nms, quant, roi_align

path, molded_path, tiles_path, raw_path = sys.argv[1:5]
t = time.perf_counter()
srv = ServingDetector(path)
load_s = time.perf_counter() - t
counters = {"nms": nms.nms_padded, "roi_align": roi_align.roi_align, "conv2d_int8": quant.conv2d_int8,
            "quantize_int8": quant.quantize_int8, "fold_conv_bn": fold.fold_conv_bn}
for k in counters.values():
    k.launches = 0
quant.conv2d_int8.route_launches = {"wgmma": 0}
molded = torch.load(molded_path).cuda()
torch.cuda.synchronize()
with torch.no_grad():
    detections, masks = srv._module(molded)
torch.cuda.synchronize()
launches = {name: k.launches for name, k in counters.items()}
routes = dict(quant.conv2d_int8.route_launches)
torch.save({"detections": detections.cpu(), "masks": masks.cpu()}, raw_path)
images = [np.repeat(t[..., None], 3, -1).astype(np.float32) for t in np.load(tiles_path)]
bs = srv.batch_size
first = srv.detect(images[:bs])
t = time.perf_counter()
results = [r for s in range(0, len(images), bs) for r in srv.detect(images[s:s + bs])]
img_s = len(images) / (time.perf_counter() - t)
for r in first + results:
    n = len(r["class_ids"])
    assert r["masks"].shape == (512, 512, n) and r["rois"].shape == (n, 4), (r["masks"].shape, r["rois"].shape)
    assert np.isfinite(r["scores"]).all()
models = sorted(m for m in sys.modules
                if m.startswith(tuple("caesar_mrcnn_tpu_torch." + n for n in ("models", "config", "weights"))))
print(json.dumps({"load_s": load_s, "nodes": caesar_nodes(srv.program), "launches": launches, "routes": routes,
                  "img_s": img_s, "detections": [len(r["class_ids"]) for r in results], "models": models}))
"""


def check_export(card_name: str) -> dict:
    """The serving export on the card (module docstring, phase 12): the
    serving flagship's bf16 graph and its int8 graph (calibrated as
    ``serving:`` calibrates it, on the first tile batch), each exported
    (``export_program``), saved (``save_artifact``) and loaded by
    ``ServingDetector`` in a fresh process that imports nothing of
    ``models/``. Returns the loaded programs' launches on one batch each."""
    import subprocess
    import sys

    import torch

    from caesar_mrcnn_tpu_torch.inference.detector import Detector, build_detector
    from caesar_mrcnn_tpu_torch.inference.export import export_program, save_artifact

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_mosaic(path)
        tiles = read_tiles(path, 2048, 512)
    det8 = build_detector(serving_config(), seed=SEED, device="cuda")
    settle_random_weights(det8.model)
    det8.collect(det8.dispatch_tiles(tiles[:det8.config.batch_size]))  # the first batch calibrates, as in serving:
    x, metas, anchors = _premold(det8, tiles[:det8.config.batch_size])
    bf16 = Detector(flagship_config(pre_nms_limit=3000, post_nms_rois_inference=512), det8.model, "cuda")
    images = [np.repeat(t[..., None], 3, -1).astype(np.float32) for t in tiles]
    per_batch = {"nms": 2, "roi_align": 2, "conv2d_int8": 0, "quantize_int8": 0, "fold_conv_bn": 0}
    total = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        molded_path, tiles_path, raw_path = (os.path.join(tmp, n) for n in ("molded.pt", "tiles.npy", "raw.pt"))
        torch.save(x.cpu(), molded_path)
        np.save(tiles_path, tiles)
        # the float graph folds its frozen batch norms (the backbone's 104 pairs, the mask head's 4: one
        # launch each) and runs FOLDED_CONVS conv_bias_relu (cuDNN's, which counts no launch)
        for name, det, expected, uncounted in (
                ("bf16", bf16, {**per_batch, "fold_conv_bn": 2}, {"conv_bias_relu": FOLDED_CONVS}),
                ("int8", det8, {**per_batch, "conv2d_int8": INT8_SITES, "quantize_int8": INT8_QUANTIZERS}, {})):
            art = os.path.join(tmp, f"{name}.pt2")
            torch.cuda.synchronize()
            t = time.perf_counter()
            program, sidecar = export_program(det)
            export_s = time.perf_counter() - t
            t = time.perf_counter()
            save_artifact(program, sidecar, art)
            save_s = time.perf_counter() - t
            del program
            live = det._step(x, metas, anchors)
            live = {"detections": live.detections.cpu(), "masks": live.masks.cpu()}
            bs = det.config.batch_size
            det.detect(images[:bs])
            t = time.perf_counter()
            counts = [len(r["class_ids"]) for s in range(0, len(images), bs) for r in det.detect(images[s:s + bs])]
            live_img_s = len(images) / (time.perf_counter() - t)
            proc = subprocess.run([sys.executable, "-c", EXPORT_SERVE, art, molded_path, tiles_path, raw_path],
                                  cwd=root, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"export {name}: the serving process failed:\n{proc.stderr[-4000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            raw = torch.load(raw_path)
            same = {k: torch.equal(raw[k], live[k]) for k in live}
            ulps = {k: 0.0 if same[k] else float(((raw[k].float() - live[k].float()).abs()
                                                  / bf16_ulp(live[k].float().abs())).max()) for k in live}
            print(f"export: {name} graph of the serving flagship (ResNet-101, FPN 256, 512^2, batch 8, 4 classes, "
                  f"3000/512 proposals): export {export_s:.2f} s, save {save_s:.2f} s, "
                  f"{os.path.getsize(art) / 1e6:.1f} MB, load {out['load_s']:.2f} s in a fresh process (models/ "
                  f"imported there: {out['models']}); caesar:: nodes {out['nodes']} [{card_name}]")
            print(f"export: {name} loaded program, one batch of 8: launches {out['launches']} (conv2d_int8 "
                  f"{out['routes']}); outputs against Detector._step on the same molded batch: bit for bit "
                  f"{same}, max difference in bf16 ulps {ulps} [{card_name}]")
            print(f"export: {name} ServingDetector.detect {out['img_s']:.2f} img/s against Detector.detect "
                  f"{live_img_s:.2f} img/s on the same 16 tiles (host clock, second pass of two batches, unmold "
                  f"included); detections per tile {out['detections']} / {counts} [{card_name}]")
            if out["models"]:
                raise AssertionError(f"export {name}: the serving process imported {out['models']}")
            nodes = {**{k: v for k, v in expected.items() if v}, **uncounted}
            if out["launches"] != expected or out["nodes"] != nodes:
                raise AssertionError(f"export {name}: launches {out['launches']}, nodes {out['nodes']}, "
                                     f"expected {expected} per batch")
            if out["routes"] != {"wgmma": expected["conv2d_int8"]}:
                raise AssertionError(f"export {name}: conv2d_int8 {out['routes']}: every site must run the "
                                     f"Hopper kernel")
            if not all(same.values()) and (name == "int8" or max(ulps.values()) > 1):
                raise AssertionError(f"export {name}: the loaded program's outputs differ from Detector._step's "
                                     f"({same}, bf16 ulps {ulps}; int8 must be bit-equal, bf16 within 1 ulp)")
            if out["detections"] != counts:
                raise AssertionError(f"export {name}: detections per tile {out['detections']} against {counts}")
            for k, v in out["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


# -------------------------------------------------------------------- train


def write_train_dataset(root: str, n_images: int = 16, size: int = 256, objects: int = 12,
                        seed: int = SEED) -> str:
    """Seeded FITS training set in ``SourceDataset``'s json layout: noise
    plus ``objects`` elliptical gaussian sources per image, each with its
    own FITS mask (8..40 px across, the density of ``bench_train.py``).
    Returns the list of json descriptors, one per line."""
    from caesar_mrcnn_tpu_torch.utils.fits import write_fits

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    paths = []
    for i in range(n_images):
        img = rng.normal(0.0, 0.05, (size, size)).astype(np.float32)
        objs = []
        for j in range(objects):
            cy, cx = rng.uniform(24, size - 24, 2)
            ry, rx = rng.uniform(4, 20, 2)
            r2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            img += rng.uniform(1.0, 20.0) * np.exp(-r2)
            mask_path = os.path.join(root, f"img{i}_obj{j}.fits")
            write_fits((r2 <= 1.0).astype(np.float32), mask_path)
            objs.append({"mask": mask_path, "class": CLASS_NAMES[1 + rng.randint(3)]})
        img_path = os.path.join(root, f"img{i}.fits")
        write_fits(img, img_path)
        paths.append(os.path.join(root, f"img{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"img": img_path, "objs": objs}, f)
    return paths


def load_train_dataset(paths):
    from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset

    ds = SourceDataset()
    ds.set_class_dict({name: i for i, name in enumerate(CLASS_NAMES) if i})
    for p in paths:
        if ds.load_data_from_json_file(p) != 0:
            raise RuntimeError(f"dataset: cannot load {p}")
    ds.prepare()
    return ds


class KernelInputs:
    """The inputs that a step or a detect call gives the kernels, kept on
    the host. While installed (``with``), the model's call sites of NMS
    (the RPN's and the per-class one), the ROIAlign forward and the
    mask-target crop go through wrappers that call the kernels unchanged
    and, while ``on`` is set, keep each call's inputs, and the gradient that
    reaches a ROIAlign output, which its backward kernel takes."""

    def __init__(self):
        self.on = False
        self.nms, self.roi_align, self.crop = [], [], []

    def __enter__(self):
        from caesar_mrcnn_tpu_torch.models import detection, mask_rcnn, proposals, targets
        from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
        from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align

        def nms(boxes, scores, max_out, thr):
            if self.on:
                self.nms.append((boxes.cpu(), scores.cpu(), int(max_out), float(thr)))
            return nms_padded(boxes, scores, max_out, thr)

        def roi(levels, boxes, image_shape, pool):
            out = roi_align(levels, boxes, image_shape, pool)
            if self.on:
                entry = {"levels": [f.detach().cpu() for f in levels], "boxes": boxes.detach().cpu(),
                         "image": tuple(image_shape), "pool": int(pool)}
                self.roi_align.append(entry)
                if out.requires_grad:
                    out.register_hook(lambda g: entry.__setitem__("grad", g.detach().cpu()))
            return out

        def crop(masks, boxes, assign, crop_size):
            if self.on:
                if not bool(((masks == 0) | (masks == 1)).all()):
                    raise AssertionError("the step's GT masks hold values other than 0 and 1")
                self.crop.append((masks.bool().cpu(), masks.dtype, boxes.cpu(), assign.cpu(), tuple(crop_size)))
            return crop_and_resize(masks, boxes, assign, crop_size)

        sites = [(proposals, "nms_padded", nms), (detection, "nms_padded", nms), (mask_rcnn, "roi_align", roi),
                 (targets, "crop_and_resize", crop)]
        self._saved = [(module, name, getattr(module, name)) for module, name, _ in sites]
        for module, name, fn in sites:
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)

    def inputs(self) -> dict:
        return {"nms": self.nms, "roi_align": self.roi_align, "crop": self.crop}


def check_train(ds, card_name: str) -> dict:
    """20 Adam steps of the training flagship through the pipeline."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN, forward_train
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align, roi_align_backward
    from caesar_mrcnn_tpu_torch.train import trainer as T

    steps = 20
    cfg = train_config()
    pipe = TrainingPipeline(ds, cfg, seed=SEED, augmentation=True, cache_bytes=1 << 30)
    batches = pipe.batches()
    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(SEED))
    settle_random_weights(model)
    model.to("cuda")
    opt = T.make_optimizer(cfg, model, "all")
    step = T.make_train_step(model, opt, pipe.anchors_normalized())
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (nms_padded, roi_align, roi_align_backward, crop_and_resize)
    for k in counters:
        k.launches = 0
    events, losses = [], []
    t = time.perf_counter()
    for _ in range(steps):
        batch = T.batch_to_device(next(batches), "cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(batch, generator=gen))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"nms": nms_padded.launches, "roi_align": roi_align.launches,
                "roi_align_backward": roi_align_backward.launches, "crop_and_resize": crop_and_resize.launches}
    expected = {"nms": steps, "roi_align": 2 * steps, "roi_align_backward": 2 * steps, "crop_and_resize": steps}
    if launches != expected:
        raise AssertionError(f"train launches {launches}, expected {expected} (1, 2, 2, 1 per step)")
    peak = torch.cuda.max_memory_allocated()
    totals = [float(l["total_loss"]) for l in losses]
    for i, l in enumerate(losses):
        bad = [k for k, v in l.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"train step {i}: non-finite {bad}")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events[2:])

    # the targets of the last batch: rounded masks in {0, 1}, only on positives;
    # and the RPN's boxes and scores before its NMS and the mask-target
    # crop's inputs, kept for the kernel checks on a real step's inputs
    with torch.no_grad(), KernelInputs() as inputs:
        inputs.on = True
        b = T.mold_batch(batch, cfg)
        out = forward_train(model, b["images"], b["gt_class_ids"], b["gt_boxes"], b["gt_masks"],
                            torch.from_numpy(pipe.anchors_normalized()).cuda(),
                            torch.tensor(cfg.rpn_bbox_std_dev, device="cuda"), generator=gen)
    if len(inputs.nms) != 1 or len(inputs.crop) != 1:
        raise AssertionError(f"a train forward made {len(inputs.nms)} NMS and {len(inputs.crop)} crop calls")
    (boxes, scores, max_out, thr), = inputs.nms
    (masks, dtype, crop_boxes, assign, crop), = inputs.crop
    pos_cap = int(cfg.train_rois_per_image * cfg.roi_positive_ratio)
    captured = {"nms": (boxes.cuda(), scores.cuda(), max_out, thr),
                "crop": (masks.cuda().to(dtype), crop_boxes.cuda(), assign.cuda(), crop),
                "rois": {cfg.pool_size: out.rois.contiguous(), cfg.mask_pool_size: out.rois[:, :pos_cap].contiguous()}}
    tm = out.target_masks
    positive = (out.target_class_ids > 0).float()
    if not bool(((tm == 0) | (tm == 1)).all()) or not bool((tm.flatten(2).amax(2) <= positive).all()):
        raise AssertionError("target masks outside {0, 1} or set on a non-positive ROI")
    n_pos = int(positive.sum())
    print(f"train: {steps} Adam steps, ResNet-101 256^2 batch 8 bf16, 16 FITS images x 12 objects "
          f"through TrainingPipeline (compact wire); launches {launches}; {n_pos} positive ROIs in the "
          f"last batch [{card_name}]")
    print(f"train: step {step_ms:.2f} ms (median of steps 3-{steps}, CUDA events), "
          f"{cfg.batch_size * 1000.0 / step_ms:.2f} img/s device-bound; {steps * cfg.batch_size / wall:.2f} img/s "
          f"with the host pipeline ({wall:.2f} s for {steps} steps); peak device memory "
          f"{peak / 2**30:.2f} GiB; total_loss first {totals[0]:.4f}, last {totals[-1]:.4f} [{card_name}]")
    print("train: losses of the last step " + json.dumps({k: round(float(v), 5) for k, v in losses[-1].items()}))
    return launches, captured


def check_train_step_boxes(captured: dict, recs: dict, card_name: str) -> None:
    """NMS, the ROIAlign forward and backward and crop_and_resize on the
    inputs of a real flagship train step (its RPN boxes and scores before
    NMS; its 512 sampled ROIs at pool 7 and 168 positive slots at pool 14,
    around 12 sources per image; its mask-target crop: the GT masks, the
    positive ROIs and their GT channels), which the seeded log-uniform
    boxes understate: these crowd onto P2. The inputs are saved for
    ``kernel_bench.py`` to ``build/train_step_boxes.pt`` (the masks, 0 or 1,
    as booleans)."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_levels

    boxes, scores, max_out, thr = captured["nms"]
    masks, crop_boxes, assign, crop = captured["crop"]
    if not bool(((masks == 0) | (masks == 1)).all()):
        raise AssertionError("the train step's GT masks hold values other than 0 and 1")
    kb.TRAIN_STEP_BOXES.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"nms": (boxes.cpu(), scores.cpu(), int(max_out), float(thr)),
                "rois": {pool: rois.cpu() for pool, rois in captured["rois"].items()},
                "crop": (masks.bool().cpu(), crop_boxes.cpu(), assign.cpu(), crop)}, kb.TRAIN_STEP_BOXES)
    nms_against_plain(recs["nms"], boxes, scores, max_out, thr, "train-step RPN", card_name)
    rng = np.random.RandomState(SEED + 1)
    levels = kb.pyramid(rng, masks.device, 8, 256, 256)
    for pool, rois in captured["rois"].items():
        per_level = torch.bincount(roi_levels(rois, 256.0 * 256.0).flatten().long(), minlength=4).tolist()
        print(f"kernels: train-step ROIs at pool {pool}: {tuple(rois.shape[:2])}, per level P2..P5 {per_level}")
        roi_align_against_plain(recs["roi_align"], levels, rois, 256, pool, "train-step", card_name)
        grad = torch.from_numpy(rng.randn(*rois.shape[:2], pool, pool, 256).astype(np.float32))
        backward_against_plain(recs["roi_align_backward"], grad.to(rois.device, torch.bfloat16), rois,
                               "train-step", card_name)
    crop_against_plain(recs["crop_and_resize"], masks, crop_boxes, assign, crop, "train-step", card_name)


# the relative L2 error bounds of a gradient by group of parameters (check_train_parity)
GRAD_BOUNDS = {"backbone": 1e-2, "FPN and heads": 1e-3}


def pre_bn_biases(model) -> set:
    """The biases of the convolutions that a trainable batch norm follows:
    under batch statistics they cancel out of the output, so their gradient
    is f32 rounding noise around 0, which no relative error can hold."""
    from caesar_mrcnn_tpu_torch.models.layers import BatchNorm

    out = set()
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            parent, _, leaf = name.rpartition(".")
            conv = {"bn_conv1": "conv1", "shortcut_bn": "shortcut"}.get(leaf, leaf.replace("bn", "conv"))
            out.add(f"{parent}.{conv}.bias")
    return out


def worst_rel(got: dict, ref: dict, skip=()) -> dict:
    """The worst relative L2 error ``|got - ref| / |ref|`` of the tensors
    of ``ref`` (but those in ``skip``) by group of parameters: (error,
    name) per group."""
    worst = {group: (0.0, "") for group in GRAD_BOUNDS}
    for k, r in ref.items():
        if k in skip:
            continue
        r = r.double()
        rel = float((got[k].double().to(r.device) - r).norm() / r.norm().clamp_min(1e-30))
        group = "backbone" if k.startswith("backbone.") else "FPN and heads"
        worst[group] = max(worst[group], (rel, k))
    return worst


def beyond(worst: dict, bounds: dict = GRAD_BOUNDS) -> bool:
    return any(worst[group][0] > bound for group, bound in bounds.items())


def show(worst: dict, held: bool = True, bounds: dict = GRAD_BOUNDS) -> str:
    return ", ".join(f"{g} {rel:.3g} ({k}" + (f"; bound {bounds[g]:g})" if held else ")")
                     for g, (rel, k) in worst.items())


def max_rel(got: dict, ref: dict) -> float:
    """The largest relative difference of the losses ``got`` from ``ref``."""
    return max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref)


def check_train_parity(ds, card_name: str) -> None:
    """One f32 SGD step of ResNet-101, batch 2, 128^2, at the flagship's
    learning rate, on the card and on the CPU: same weights (nonzero biases
    and batch norms), batch (given ROIs, so that near-tied proposals cannot
    fork the targets) and priorities, TF32 off.

    Held: the five losses within 1e-4 relative; each parameter's gradient
    within a relative L2 error (``|g_card - g_cpu| / |g_cpu|`` per tensor)
    of 1e-3 in the FPN and the heads and 1e-2 in the backbone. The
    gradient, not the updated weight, so that neither the learning rate
    nor the weight's size hides a fault. The bounds differ because the
    backbone's gradient passes some hundred ReLUs, where f32 rounding flips
    pre-activations near 0: the CPU against itself at another thread count
    differs there by up to 1.1e-3, and the FPN, next to the ROIAlign
    gradient, by 2e-5 card against CPU (an H100 80GB HBM3). On that card,
    a backward kernel that drops one of its four taps moved the FPN's
    gradients by 0.12, and one that loses the P3 level by 7e-3. SGD, because Adam's first update is the sign of each
    gradient element, which rounding decides for elements near zero."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.models.targets import sampling_width
    from caesar_mrcnn_tpu_torch.train import trainer as T

    cfg = train_config(image_min_dim=128, image_max_dim=128, images_per_device=2, compute_dtype="float32",
                       optimizer="sgd", use_rpn_rois=False)
    pipe = TrainingPipeline(ds, cfg, seed=SEED)
    batch = next(pipe.batches())
    width = sampling_width(batch["rois"].shape[1], cfg)
    prio = tuple(torch.rand((2, width), generator=torch.Generator().manual_seed(SEED)) for _ in range(2))
    init = MaskRCNN(cfg)
    W.init_weights(init, torch.Generator().manual_seed(SEED))
    randomize_affine(init)
    settle_random_weights(init)
    state = init.state_dict()
    results = []
    for device in ("cuda", "cpu"):
        model = MaskRCNN(cfg)
        model.load_state_dict(state)
        model.to(device)
        step = T.make_train_step(model, T.make_optimizer(cfg, model, "all"), pipe.anchors_normalized())
        losses = step(T.batch_to_device(batch, device), priorities=tuple(p.to(device) for p in prio))
        results.append(({k: float(v) for k, v in losses.items()},
                        {k: v.grad.cpu().double() for k, v in model.named_parameters()}))
    (gl, gg), (cl, cg) = results
    loss_rel = max_rel(gl, cl)
    worst = worst_rel(gg, cg)
    print(f"train parity: one f32 SGD step (learning rate {cfg.learning_rate}), ResNet-101 batch 2 128^2, card vs "
          f"CPU: losses max rel diff {loss_rel:.3g} (total {gl['total_loss']:.6f} / {cl['total_loss']:.6f}); "
          f"gradients' worst relative L2 error: {show(worst)} [{card_name}]")
    if loss_rel > 1e-4 or beyond(worst):
        raise AssertionError(f"train parity beyond its bounds: losses {gl} vs {cl}; gradients {worst}")


# ----------------------------------------------------------- train options

OPTION_STEPS = 8  # steps of each option (median of steps 3-8)
TRAIN_OPTIONS = (("train_bn", dict(train_bn=True)), ("remat backbone", dict(train_remat="backbone")),
                 ("remat all", dict(train_remat="all")), ("bf16 moment", dict(opt_state_dtype="bfloat16")))
# train_bn's gradients, card against CPU from the same state. f32 rounding
# grows through every batch norm's batch statistics (at batch 2, 128^2,
# res5's see 32 values a channel), so the step is also evaluated in f64 on
# the CPU, the witness, and the card's f32 gradients are held within
# BN_WITNESS_FACTOR times the CPU's own f32 distance from it, group by group
# (the worst relative L2 error of a tensor, not of the biases a batch norm
# follows). Measured on an H100 and its host's CPU: the CPU's f32 0.0547
# from f64 in the backbone and 0.0108 in the FPN and heads; the card's
# 0.0348 and 0.0327 (fpn.fpn_p5.weight, 3.0x the CPU's: cuDNN's convolution
# algorithms, as the card's step without cuDNN, 0.0423 and 0.00645, shows);
# with the ROIAlign backward kernel dropping the last row of each box's
# footprint, 0.119 and 0.0687. A factor of 3 failed the sound card by 1%.
BN_WITNESS_FACTOR = 4.0
# train_bn under data parallelism, two ranks against one process on the
# card from the same state (relative L2 of the gradients and the trace).
# Measured on an H100 (four runs): at most 0.0527 in the backbone and
# 0.0418 in the FPN and heads; with the backward's all-reduce of the
# statistics' gradients dropped, 2.09-2.16 and 2.38-2.69 (batch norms'
# biases)
DIST_BN_GRAD_BOUNDS = {"backbone": 0.2, "FPN and heads": 0.1}
# the batch norm layer alone, two ranks against one process on the card:
# output, input gradient, scale and bias gradients (max-abs relative).
# Measured on an H100: at most 9.0e-6 (the scale's); the input gradient
# 4.3e-7, and 0.123 with the backward's all-reduce dropped
BN_LAYER_BOUND = 1e-3
# a remat step against the step without remat on the card (cuDNN and the
# backward's atomics are not deterministic: measured 1.7e-06 / 1.1e-07)
REMAT_GRAD_BOUNDS = {"backbone": 1e-3, "FPN and heads": 1e-4}
BN_STATS_BOUND = 1e-3  # committed running statistics, card vs CPU, of each tensor's max-abs


def _option_model(cfg, device="cuda", affine: bool = False, settle: bool = True):
    """The flagship's seeded random weights (flax's scheme; nonzero biases
    and batch norms with ``affine``; settled with ``settle``) on ``device``."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(SEED))
    if affine:
        randomize_affine(model)
    if settle:
        settle_random_weights(model)
    return model.to(device)


def _run_option(ds, cfg, capture=None) -> dict:
    """OPTION_STEPS Adam steps of ``cfg`` through ``TrainingPipeline``: step
    ms (CUDA events), peak memory, the losses, the launches; ``capture``
    (:class:`KernelInputs`) keeps the first step's kernel inputs."""
    import torch

    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.train import trainer as T

    pipe = TrainingPipeline(ds, cfg, seed=SEED, augmentation=True, cache_bytes=1 << 30)
    batches = pipe.batches()
    model = _option_model(cfg)
    opt = T.make_optimizer(cfg, model, "all")
    step = T.make_train_step(model, opt, pipe.anchors_normalized())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # earlier phases' tensors and this model
    _zero_launches()
    events, losses = [], []
    for k in range(OPTION_STEPS):
        batch = T.batch_to_device(next(batches), "cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if capture is not None:
            capture.on = k == 0
        start.record()
        losses.append(step(batch, generator=gen))
        end.record()
        if capture is not None:
            capture.on = False
        events.append((start, end))
    torch.cuda.synchronize()
    out = {"launches": _launches(), "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "resident_gib": resident / 2 ** 30,
           "step_ms": statistics.median(s.elapsed_time(e) for s, e in events[2:]),
           "first": float(losses[0]["total_loss"]), "last": float(losses[-1]["total_loss"]),
           "finite": all(bool(torch.isfinite(v)) for l in losses for v in l.values())}
    if cfg.opt_state_dtype == "bfloat16":
        out["moment"] = str(opt.state["mu"][0].dtype)
    if cfg.train_bn:  # the running mean starts at 0 (flax's init)
        out["stats_moved"] = float(model.backbone.bn_conv1.mean.abs().max())
    return out


def _one_step(model, cfg, batch, priorities, device) -> tuple:
    """One f32 SGD step of ``model`` on ``device``: (losses, gradients by
    name, the running statistics after it)."""
    from caesar_mrcnn_tpu_torch.train import trainer as T
    from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

    step = T.make_train_step(model, T.make_optimizer(cfg, model, "all"), get_anchors(cfg))
    losses = step(T.batch_to_device(batch, device), priorities=tuple(p.to(device) for p in priorities))
    grads = {k: v.grad.detach().cpu().double() for k, v in model.named_parameters()}
    stats = {k: v.detach().cpu().double() for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    return {k: float(v) for k, v in losses.items()}, grads, stats


def check_train_options_parity(ds, card_name: str) -> None:
    """``train_bn``: one f32 SGD step (ResNet-101, batch 2, 128^2, given
    ROIs and priorities, TF32 off, the batch's mean pixel) on the card and
    on the CPU from the same state, and the same step in f64 on the CPU
    (the witness): losses within 1e-4 relative, card against CPU; the
    card's gradients no further from the witness than BN_WITNESS_FACTOR
    times the CPU's f32 gradients are, group by group (relative L2; not the
    biases a batch norm follows, :func:`pre_bn_biases`); the committed
    running statistics within BN_STATS_BOUND of each tensor's max-abs, card
    against CPU. Remat: the same step (frozen batch norm) with
    ``train_remat`` "backbone" and "all" against the step without it, all
    three on the card from the same state: losses within 1e-6, gradients
    within REMAT_GRAD_BOUNDS."""
    import torch

    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.targets import sampling_width

    base = dict(image_min_dim=128, image_max_dim=128, images_per_device=2, compute_dtype="float32",
                optimizer="sgd", use_rpn_rois=False)
    batch = next(TrainingPipeline(ds, train_config(**base), seed=SEED).batches())
    mean = float(np.asarray(batch["images"], np.float64).mean())
    cfg = train_config(**base, train_bn=True, mean_pixel=(mean,) * 3)
    width = sampling_width(batch["rois"].shape[1], cfg)
    prio = tuple(torch.rand((2, width), generator=torch.Generator().manual_seed(SEED)) for _ in range(2))
    state = _option_model(cfg, "cpu", affine=True, settle=False).state_dict()
    results = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        model = _option_model(cfg, "cpu", affine=True, settle=False)
        model.load_state_dict(state)
        if dtype == torch.float64:  # the witness: parameters and activations in f64
            model.double()
            model.dtype = torch.float64
        results.append(_one_step(model.to(device), cfg, batch, prio, device))
    (gl, gg, gs), (cl, cg, cs), (_, wg, _) = results
    noise = pre_bn_biases(model)
    torch.backends.cudnn.enabled = False  # not held: the card's step with PyTorch's own convolutions
    try:
        model = _option_model(cfg, "cpu", affine=True, settle=False)
        model.load_state_dict(state)
        native_gap = worst_rel(_one_step(model.to("cuda"), cfg, batch, prio, "cuda")[1], wg, noise)
    finally:
        torch.backends.cudnn.enabled = True
    loss_rel = max_rel(gl, cl)
    worst = worst_rel(gg, cg, noise)
    card_gap, cpu_gap = worst_rel(gg, wg, noise), worst_rel(cg, wg, noise)
    bounds = {g: BN_WITNESS_FACTOR * cpu_gap[g][0] for g in cpu_gap}
    stats_rel = max(float((gs[k] - cs[k]).abs().max() / cs[k].abs().max().clamp_min(1e-30)) for k in cs)
    moved = max(float((cs[k] - state[k].double()).abs().max()) for k in cs)
    print(f"train options parity: train_bn, one f32 SGD step, ResNet-101 batch 2 128^2 (mean pixel {mean:.2f}): "
          f"losses card vs CPU max rel diff {loss_rel:.3g} (bound 1e-4); gradients' worst relative L2 error "
          f"against the CPU's f64 step: card {show(card_gap, bounds=bounds)}; CPU f32 {show(cpu_gap, False)} "
          f"(bounds {BN_WITNESS_FACTOR:g} x the CPU's); not held: the card without cuDNN "
          f"{show(native_gap, False)}, the card against the CPU {show(worst, False)}; "
          f"committed running statistics {stats_rel:.3g} of their scale (bound {BN_STATS_BOUND:g}; they moved by "
          f"up to {moved:.3g}) [{card_name}]")
    failures = []
    if loss_rel > 1e-4 or beyond(card_gap, bounds) or stats_rel > BN_STATS_BOUND or moved == 0:
        failures.append(f"train_bn card vs CPU beyond its bounds: losses {gl} vs {cl}; gradients against f64 "
                        f"{card_gap}, the CPU's {cpu_gap}; statistics {stats_rel}")

    cfg = train_config(**base, mean_pixel=(mean,) * 3)
    state = _option_model(cfg, "cpu", affine=True).state_dict()
    runs = {}
    for remat in ("none", "backbone", "all"):
        c = cfg.replace(train_remat=remat)
        model = _option_model(c, "cpu", affine=True)
        model.load_state_dict(state)
        runs[remat] = _one_step(model.to("cuda"), c, batch, prio, "cuda")
    for remat in ("backbone", "all"):
        loss_rel = max_rel(runs[remat][0], runs["none"][0])
        worst = worst_rel(runs[remat][1], runs["none"][1])
        print(f"train options parity: train_remat={remat!r} against no remat, one f32 SGD step on the card from "
              f"the same state: losses max rel diff {loss_rel:.3g} (bound 1e-6); gradients' worst relative L2 "
              f"error: {show(worst, bounds=REMAT_GRAD_BOUNDS)} [{card_name}]")
        if loss_rel > 1e-6 or beyond(worst, REMAT_GRAD_BOUNDS):
            failures.append(f"remat {remat} against no remat beyond its bounds: {loss_rel}, {worst}")
    if failures:
        raise AssertionError("train options: " + "\ntrain options: ".join(failures))


def check_train_options(ds, recs: dict, card_name: str) -> dict:
    """Each training option of TRAIN_OPTIONS at the training flagship's
    width through ``TrainingPipeline`` (OPTION_STEPS Adam steps): step ms,
    img/s, peak memory, first and last loss, launches (1 NMS, 2 ROIAlign
    forward, 2 backward, 1 crop a step, under remat too); then the
    parities (:func:`check_train_options_parity`) and the four kernels
    against their plain versions on the inputs of the first ``train_bn``
    step. Returns the options' launches, summed."""
    import contextlib

    import torch

    t0 = time.perf_counter()
    total = {k: 0 for k in _dist_counters()}
    expected = {"nms": OPTION_STEPS, "roi_align": 2 * OPTION_STEPS, "roi_align_backward": 2 * OPTION_STEPS,
                "crop_and_resize": OPTION_STEPS}
    captured = KernelInputs()
    rows, failures = {}, []
    for name, option in TRAIN_OPTIONS:
        cfg = train_config(**option)
        with captured if name == "train_bn" else contextlib.nullcontext():
            r = _run_option(ds, cfg, captured if name == "train_bn" else None)
        rows[name] = r
        total = {k: total[k] + r["launches"][k] for k in total}
        extra = (f"; moment {r['moment']}" if "moment" in r else "") + \
            (f"; bn_conv1 running mean moved by {r['stats_moved']:.4g}" if "stats_moved" in r else "")
        print(f"train options: {name}, {OPTION_STEPS} Adam steps of ResNet-101 256^2 batch 8 bf16: step "
              f"{r['step_ms']:.2f} ms (median of steps 3-{OPTION_STEPS}, CUDA events), "
              f"{cfg.batch_size * 1000.0 / r['step_ms']:.2f} img/s; peak device memory {r['peak_gib']:.2f} GiB "
              f"({r['resident_gib']:.2f} GiB resident before the first step: the model and earlier phases' "
              f"tensors); "
              f"total_loss first {r['first']:.4f}, last {r['last']:.4f}, all finite {r['finite']}; launches "
              f"{r['launches']}{extra} [{card_name}]")
        if r["launches"] != expected:
            failures.append(f"{name}: launches {r['launches']}, expected {expected} (1, 2, 2, 1 a step)")
        if not r["finite"] or r.get("moment", "torch.bfloat16") != "torch.bfloat16" or r.get("stats_moved", 1) == 0:
            failures.append(f"{name}: {r}")
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("train options: " + "\ntrain options: ".join(failures))
    check_train_options_parity(ds, card_name)
    torch.cuda.empty_cache()
    check_captured_kernels({"train_bn step": captured.inputs()}, {"train_bn step": (1, 2, 1)}, recs, card_name,
                           "train options")
    print(f"train options: phase {time.perf_counter() - t0:.2f} s; launches {total} [{card_name}]")
    return total


# --------------------------------------------------------------------- dist

DIST_STEPS = 3  # f32 SGD steps of the data-parallel parity
DIST_TIMED = 12  # bf16 Adam steps of the timing run (median of the last 10)
BN_STEPS = 2  # f32 SGD train_bn steps of the data-parallel parity (global batch statistics)
BN_TIMED = 3  # f32 SGD train_bn steps timed plain, then as many with the statistics' all-reduces timed


def _dist_counters():
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align, roi_align_backward

    return {"nms": nms_padded, "roi_align": roi_align, "roi_align_backward": roi_align_backward,
            "crop_and_resize": crop_and_resize}


def _zero_launches() -> None:
    for k in _dist_counters().values():
        k.launches = 0


def _launches() -> dict:
    return {name: k.launches for name, k in _dist_counters().items()}


def _restore_launches(counts: dict) -> None:
    for name, k in _dist_counters().items():
        k.launches = counts[name]


def _train_parity_inputs(ds, job: str) -> None:
    """The f32 parity's inputs, written to ``job``: the flagship's settled
    random weights (nonzero biases and batch norms), three global batches of
    8 with given ROIs, their global sampling priorities, and the mean pixel
    of the ``train_bn`` steps' batches (flax's fast variance, ``E[x^2] -
    E[x]^2`` in f32, cancels where the stem's input keeps a large mean)."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.models.targets import sampling_width

    cfg = _dist_parity_config()
    it = TrainingPipeline(ds, cfg, seed=SEED).batches()
    batches = [next(it) for _ in range(DIST_STEPS)]
    width = sampling_width(batches[0]["rois"].shape[1], cfg)
    gen = torch.Generator().manual_seed(SEED)
    priorities = [tuple(torch.rand((cfg.batch_size, width), generator=gen) for _ in range(2)) for _ in batches]
    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(SEED))
    randomize_affine(model)
    settle_random_weights(model)
    mean = float(np.mean([np.asarray(b["images"], np.float64).mean() for b in batches[:BN_STEPS]]))
    torch.save({"state": model.state_dict(), "batches": batches, "priorities": priorities, "mean_pixel": mean},
               job)


def _dist_parity_config(**kw):
    """The training flagship's widths at f32, SGD, given ROIs (2000 of
    them), global batch 8 over two ranks."""
    return train_config(compute_dtype="float32", optimizer="sgd", use_rpn_rois=False, images_per_device=4,
                        num_devices=2, **kw)


def _sgd_steps(model, cfg, batches, priorities, device, group=None, rank=0, world=1, reference=None,
               capture=None):
    """``len(batches)`` f32 SGD steps, on this rank's rows of each global
    batch with a group, on all of it without; returns each step's losses.

    With ``reference`` (a second model), before each step the reference
    takes this model's parameters and optimizer state and makes the
    one-process step on the whole global batch; the two steps are compared,
    and the second list returned holds, per step, the losses' largest
    relative difference and the worst relative L2 errors of the gradients
    and of the optimizer's trace (the update before the learning rate: the
    clipped gradient, the L2 term and the momentum), not of the biases a
    trainable batch norm follows (:func:`pre_bn_biases`), and the committed
    running statistics' largest difference. ``capture``
    (:class:`KernelInputs`) keeps the first step's kernel inputs."""
    from caesar_mrcnn_tpu_torch.parallel.mesh import shard_batch
    from caesar_mrcnn_tpu_torch.train import trainer as T
    from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

    def grads(opt):
        return {n: p.grad if p.grad is not None else p.new_zeros(p.shape) for n, p in zip(opt.names, opt.params)}

    anchors = get_anchors(cfg)
    opt = T.make_optimizer(cfg, model, "all")
    step = T.make_train_step(model, opt, anchors, group=group)
    noise = pre_bn_biases(model)  # empty under frozen batch norm
    if reference is not None:
        ref_opt = T.make_optimizer(cfg, reference, "all")
        ref_step = T.make_train_step(reference, ref_opt, anchors)
    losses, same_state = [], []
    for k, (batch, prio) in enumerate(zip(batches, priorities)):
        prio = tuple(p.to(device) for p in prio)
        if reference is not None:  # a comparison: its launches are not the path's
            counts = _launches()
            reference.load_state_dict(model.state_dict())
            for mine, theirs in zip(ref_opt.state["trace"], opt.state["trace"]):
                mine.copy_(theirs)
            ref_losses = ref_step(T.batch_to_device(batch, device), priorities=prio)
            _restore_launches(counts)
        local = shard_batch(batch, world, rank) if group is not None else batch
        if capture is not None:
            capture.on = k == 0
        out = step(T.batch_to_device(local, device), priorities=prio)
        if capture is not None:
            capture.on = False
        losses.append({n: float(v) for n, v in out.items()})
        if reference is not None:
            same_state.append({
                "losses": max_rel(losses[-1], {n: float(v) for n, v in ref_losses.items()}),
                "gradients": worst_rel(grads(opt), grads(ref_opt), noise),
                "trace": worst_rel(dict(zip(opt.names, opt.state["trace"])),
                                   dict(zip(ref_opt.names, ref_opt.state["trace"])), noise),
                "stats": stats_rel(model, reference),
            })
    return losses, same_state


def stats_rel(model, reference) -> float:
    """The largest difference of the two models' running statistics, of
    each tensor's max-abs."""
    mine, theirs = model.state_dict(), reference.state_dict()
    return max((float((mine[k].double() - theirs[k].double()).abs().max() / theirs[k].abs().max().clamp_min(1e-30))
                for k in theirs if k.endswith((".mean", ".var"))), default=0.0)


def _bn_layer_parity(group, rank: int, world: int, device) -> dict:
    """The trainable batch norm alone with the global batch's statistics
    (its ``(sum x, sum x^2)`` through ``parallel.dist.all_reduce_sum``)
    against one process on the global batch, on the card, at the stem
    batch norm's shape in the dist phase ([8, 64, 64, 64] f32, 4 images a
    rank; an input mean of 3) under the loss ``sum(y * w)`` with ``w`` of
    mean 1. Every rank takes part; rank 0 returns the largest difference,
    of the reference's max-abs, of the output, of the input's gradient
    (the ranks' rows gathered) and of the scale's and bias's gradients
    (summed over the ranks). The input gradient reaches the other ranks'
    loss terms only through the backward's all-reduce: ``w``'s mean makes
    those terms a large part of it."""
    import torch
    import torch.distributed as dist

    from caesar_mrcnn_tpu_torch.models import layers as L

    gen = torch.Generator().manual_seed(SEED)
    n, c, h = 8, 64, 64
    x = torch.randn(n, c, h, h, generator=gen) * 2.0 + 3.0
    w = torch.randn(n, c, h, h, generator=gen) + 1.0
    scale, bias = torch.rand(c, generator=gen) + 0.5, torch.rand(c, generator=gen) - 0.5
    rows = slice(rank * n // world, (rank + 1) * n // world)

    def run(xs, ws, grp):
        holder = torch.nn.Module()
        holder.bn = L.BatchNorm(c).to(device)
        with torch.no_grad():
            holder.bn.scale.copy_(scale)
            holder.bn.bias.copy_(bias)
        xs = xs.to(device).requires_grad_(True)
        with L.batch_statistics(holder, grp):
            y = holder.bn(xs)
        (y * ws.to(device)).sum().backward()
        return [y.detach(), xs.grad, holder.bn.scale.grad, holder.bn.bias.grad]

    mine = run(x[rows], w[rows], group)
    full = []
    for t in mine[:2]:  # the ranks' rows, gathered by a sum
        whole = torch.zeros((n,) + t.shape[1:], dtype=t.dtype, device=device)
        whole[rows] = t
        dist.all_reduce(whole, group=group)
        full.append(whole)
    for t in mine[2:]:
        t = t.clone()
        dist.all_reduce(t, group=group)
        full.append(t)
    if rank != 0:
        return {}
    ref = run(x, w, None)
    return {name: float((a - b).abs().max() / b.abs().max()) for name, a, b in
            zip(("output", "input gradient", "scale gradient", "bias gradient"), full, ref)}


class BNReduceTimer:
    """While installed, each all-reduce of the batch norms' global
    statistics (``parallel.dist.all_reduce_sum``: the forward's sums and
    the backward's gradients) is timed on the host clock with the card
    synchronized around it; ``ms`` and ``count`` accumulate."""

    def __enter__(self):
        import torch

        from caesar_mrcnn_tpu_torch.models import layers
        from caesar_mrcnn_tpu_torch.parallel import dist as D

        self.ms, self.count = 0.0, 0
        self._saved = (layers.all_reduce_sum, D._AllReduceSum.backward)

        def timed(fn):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                self.ms += 1e3 * (time.perf_counter() - t)
                self.count += 1
                return out
            return run

        layers.all_reduce_sum = timed(self._saved[0])
        D._AllReduceSum.backward = staticmethod(timed(self._saved[1]))
        return self

    def __exit__(self, *exc):
        from caesar_mrcnn_tpu_torch.models import layers
        from caesar_mrcnn_tpu_torch.parallel import dist as D

        layers.all_reduce_sum, D._AllReduceSum.backward = self._saved[0], staticmethod(self._saved[1])


def _bn_timing(model, cfg, job: dict, device, group, rank: int, world: int) -> dict:
    """BN_TIMED f32 SGD ``train_bn`` steps of this rank (host clock,
    synchronized), then BN_TIMED more with the statistics' all-reduces
    timed (:class:`BNReduceTimer`): the median step ms of each, and the
    all-reduces' count and ms per step."""
    import contextlib

    import torch

    from caesar_mrcnn_tpu_torch.parallel.mesh import shard_batch
    from caesar_mrcnn_tpu_torch.train import trainer as T
    from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

    step = T.make_train_step(model, T.make_optimizer(cfg, model, "all"), get_anchors(cfg), group=group)
    plain, timed, reduce_ms, counts = [], [], [], []
    for k in range(2 * BN_TIMED):
        i = k % len(job["batches"])
        batch = T.batch_to_device(shard_batch(job["batches"][i], world, rank), device)
        prio = tuple(p.to(device) for p in job["priorities"][i])
        with BNReduceTimer() if k >= BN_TIMED else contextlib.nullcontext() as timer:
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            step(batch, priorities=prio)
            torch.cuda.synchronize(device)
            (timed if timer else plain).append(1e3 * (time.perf_counter() - t))
        if timer:
            reduce_ms.append(timer.ms)
            counts.append(timer.count)
    return {"step_ms": statistics.median(plain), "instrumented_step_ms": statistics.median(timed),
            "reduce_ms": statistics.median(reduce_ms), "reduces": counts}


def _timed_train(ds_paths, cfg, group, rank, world, device, capture=None) -> dict:
    """DIST_TIMED bf16 Adam steps through the RPN path on this rank's rows
    of the pipeline's global batches: the median step ms (CUDA events), the
    median host ms to make a batch (``next`` of ``TrainingPipeline.batches``,
    one sample thread: a rank makes the whole global batch and keeps its
    rows) and, with a group, the gradient all-reduce's median ms and MB.
    ``capture`` (:class:`KernelInputs`) keeps the first step's kernel
    inputs."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.parallel.mesh import shard_rows
    from caesar_mrcnn_tpu_torch.train import trainer as T

    pipe = TrainingPipeline(load_train_dataset(ds_paths), cfg, seed=SEED, augmentation=True, cache_bytes=1 << 30)
    rows = shard_rows(cfg.batch_size, world, rank) if group is not None else None
    batches = pipe.batches(rows=rows)
    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(SEED))
    settle_random_weights(model)
    model.to(device)
    if group is not None:
        T.broadcast_parameters(model, group)
    step = T.make_train_step(model, T.make_optimizer(cfg, model, "all"), pipe.anchors_normalized(), group=group)
    reduce_ms = []
    if group is not None:
        reducer = step.grad_reducer
        reduce = reducer.reduce

        def timed_reduce():
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            reduce()
            torch.cuda.synchronize(device)
            reduce_ms.append(1e3 * (time.perf_counter() - t))

        reducer.reduce = timed_reduce
    gen = torch.Generator(device=device).manual_seed(SEED)
    events, totals, data_ms = [], [], []
    for k in range(DIST_TIMED):
        t = time.perf_counter()
        batch = next(batches)
        data_ms.append(1e3 * (time.perf_counter() - t))
        batch = T.batch_to_device(batch, device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if capture is not None:
            capture.on = k == 0
        start.record()
        losses = step(batch, generator=gen)
        end.record()
        if capture is not None:
            capture.on = False
        events.append((start, end))
        totals.append(losses["total_loss"])
    torch.cuda.synchronize(device)
    if not all(bool(torch.isfinite(t)) for t in totals):
        raise AssertionError(f"dist: non-finite losses in the timed run {[float(t) for t in totals]}")
    out = {"step_ms": statistics.median(s.elapsed_time(e) for s, e in events[2:]),
           "data_ms": statistics.median(data_ms[2:]), "first_loss": float(totals[0]),
           "last_loss": float(totals[-1])}
    if group is not None:
        out.update(reduce_ms=statistics.median(reduce_ms[2:]), reduce_mb=step.grad_reducer.bytes / 2 ** 20)
    return out


def _dist_catalogs(tmp: str, device, stem: str) -> dict:
    """SFinder.run_tiled in this process (one rank of a group, or alone):
    the f32 pinned-heads catalog of the seeded 1024^2 blocks mosaic (batch
    4) and the bf16 flagship's of the seeded 2048^2 mosaic (batch 8, every
    detection kept), written by rank 0 to ``tmp/<stem>_f32`` and
    ``tmp/<stem>_bf16``; wall seconds of each."""
    from caesar_mrcnn_tpu_torch.analysis.sfinder import SFinder
    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.testing import pin_heads

    walls = {}
    for name, cfg, mosaic in (("f32", flagship_config(images_per_device=4, compute_dtype="float32",
                                                      split_img_in_tiles=True), "blocks.fits"),
                              ("bf16", flagship_config(score_thr=0.0, split_img_in_tiles=True), "mosaic.fits")):
        det = build_detector(cfg, seed=SEED, device=device)
        (pin_heads if name == "f32" else settle_random_weights)(det.model)
        sf = SFinder(det, cfg)
        out = os.path.join(tmp, f"{stem}_{name}")
        sf.outfile_json, sf.outfile_ds9 = f"{out}.json", f"{out}.reg"
        t = time.perf_counter()
        sf.run_tiled(os.path.join(tmp, mosaic))
        walls[name] = time.perf_counter() - t
    return walls


def dist_worker(rank: int, world: int, port: int, tmp: str, ds_paths: list) -> None:
    """One rank of the ``dist:`` phase, spawned by :func:`check_dist`: both
    ranks on ``cuda:0`` over Gloo. Writes ``tmp/rank<r>.json`` (losses,
    rank 0's comparisons of every parity step with one process's step from
    the same state, timings, launches, whether its parameters equal rank
    0's bit for bit); rank 0 also writes its parameters after the parity
    steps to ``tmp/dp_params.pt`` and the kernel inputs of its first parity
    step and its first timed step to ``tmp/kernel_inputs.pt``."""
    import torch
    import torch.distributed as dist

    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.parallel import dist as D

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    backend = D.init_process_group(rank, world, device, port=port, timeout_s=300.0)
    group = dist.group.WORLD
    out = {"backend": backend}
    _zero_launches()

    job = torch.load(os.path.join(tmp, "parity.pt"), weights_only=False)
    cfg = _dist_parity_config()
    model = MaskRCNN(cfg)
    model.load_state_dict(job["state"])
    model.to(device)
    reference = MaskRCNN(cfg).to(device) if rank == 0 else None
    parity, timed, bn = KernelInputs(), KernelInputs(), KernelInputs()
    with parity:
        out["parity_losses"], out["same_state"] = _sgd_steps(
            model, cfg, job["batches"], job["priorities"], device, group, rank, world, reference,
            parity if rank == 0 else None)
    params = [p.detach() for p in model.parameters()]
    theirs = [p.clone() for p in params]
    D.broadcast_tensors_(theirs, 0, group)
    out["unequal_to_rank0"] = int(sum(int((a != b).sum()) for a, b in zip(params, theirs)))
    if rank == 0:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(tmp, "dp_params.pt"))
    del model, reference, params, theirs

    # train_bn: the global batch's statistics; each step against one process's from the same state
    bn_cfg = _dist_parity_config(train_bn=True, mean_pixel=(job["mean_pixel"],) * 3)
    model = MaskRCNN(bn_cfg)
    model.load_state_dict(job["state"])
    model.to(device)
    reference = MaskRCNN(bn_cfg).to(device) if rank == 0 else None
    with bn:
        out["bn_losses"], out["bn_same_state"] = _sgd_steps(
            model, bn_cfg, job["batches"][:BN_STEPS], job["priorities"][:BN_STEPS], device, group, rank, world,
            reference, bn if rank == 0 else None)
    state = [t.detach() for t in model.state_dict().values()]
    theirs = [t.clone() for t in state]
    D.broadcast_tensors_(theirs, 0, group)
    out["bn_unequal_to_rank0"] = int(sum(int((a != b).sum()) for a, b in zip(state, theirs)))
    del reference, state, theirs
    out["bn_layer"] = _bn_layer_parity(group, rank, world, device)
    out["bn_timing"] = _bn_timing(model, bn_cfg, job, device, group, rank, world)
    del model, job
    torch.cuda.empty_cache()

    with timed:
        out["timed"] = _timed_train(ds_paths, train_config(images_per_device=4, num_devices=2), group, rank, world,
                                    device, timed if rank == 0 else None)
    if rank == 0:
        torch.save({"parity": parity.inputs(), "timed": timed.inputs(), "train_bn": bn.inputs()},
                   os.path.join(tmp, "kernel_inputs.pt"))
    del parity, timed, bn
    torch.cuda.empty_cache()
    out["catalog_s"] = _dist_catalogs(tmp, device, "two")
    out["launches"] = _launches()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def check_dist(ds, ds_paths: list, recs: dict, card_name: str) -> dict:
    """Data parallelism on the one card (ROADMAP A13): two spawned ranks over
    Gloo, both on ``cuda:0``, then one NCCL rank, then the Detector over two
    devices; then the kernels against their plain versions on the inputs
    this path gave them (:func:`check_dist_kernels`). Not a scaling
    measurement: the two ranks share one card."""
    import logging

    import torch
    import torch.multiprocessing as mp

    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.parallel.dist import free_port
    from caesar_mrcnn_tpu_torch.testing import catalog_differences

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _train_parity_inputs(ds, os.path.join(tmp, "parity.pt"))
        write_blocks_mosaic(os.path.join(tmp, "blocks.fits"), 1024, 1024)
        write_mosaic(os.path.join(tmp, "mosaic.fits"), 2048)
        t = time.perf_counter()
        mp.start_processes(dist_worker, args=(2, free_port(), tmp, ds_paths), nprocs=2, join=True,
                           start_method="spawn")
        spawn_s = time.perf_counter() - t
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        dp_params = torch.load(os.path.join(tmp, "dp_params.pt"))
        kernel_inputs = torch.load(os.path.join(tmp, "kernel_inputs.pt"))

        # the one-process references on the card: the global batch of 8, twice
        # (two runs of one process differ as the ranks differ from one), then batch 4 alone
        job = torch.load(os.path.join(tmp, "parity.pt"), weights_only=False)
        cfg = _dist_parity_config()
        runs = []
        for _ in range(2):
            model = MaskRCNN(cfg)
            model.load_state_dict(job["state"])
            model.to("cuda")
            losses, _ = _sgd_steps(model, cfg, job["batches"], job["priorities"], "cuda")
            runs.append((losses, {k: p.detach().cpu() for k, p in model.named_parameters()}))
            del model
            torch.cuda.empty_cache()
        start = job["state"]
        one_timed = _timed_train(ds_paths, train_config(images_per_device=4), None, 0, 1, "cuda")
        one_catalog_s = _dist_catalogs(tmp, "cuda", "one")
        catalogs = {}
        for stem in ("one", "two"):
            for name in ("f32", "bf16"):
                with open(os.path.join(tmp, f"{stem}_{name}.json")) as f:
                    catalogs[stem, name] = json.load(f)
        with open(os.path.join(tmp, "two_bf16.reg")) as f:
            regions = f.read()

    (one_losses, one_params), (again_losses, again_params) = runs
    names = list(one_params)
    dp_params = {k: dp_params[k] for k in names}
    loss_rel = max(max_rel(got, ref) for got, ref in zip(ranks[0]["parity_losses"], one_losses))
    again_rel = max(max_rel(got, ref) for got, ref in zip(again_losses, one_losses))
    ranks_equal = ranks[0]["parity_losses"] == ranks[1]["parity_losses"] and ranks[1]["unequal_to_rank0"] == 0
    same_state = ranks[0]["same_state"]
    params = worst_rel(dp_params, one_params)

    def updates(got):
        return {k: got[k].double() - start[k].double() for k in names}

    print(f"dist: data-parallel train parity, 2 ranks over {ranks[0]['backend']} on cuda:0, {DIST_STEPS} f32 SGD "
          f"steps of ResNet-101 256^2 (global batch 8 = 4 per rank, 2000 given ROIs, 512 ROIs, 300 GT, given "
          f"global priorities) [{card_name}]")
    for k, s in enumerate(same_state):
        print(f"dist: step {k + 1} against one process's step on the global batch from the same parameters and "
              f"optimizer state: losses max rel diff {s['losses']:.3g} (bound 1e-4); worst relative L2 error of "
              f"the gradients: {show(s['gradients'])}; of the optimizer's trace: {show(s['trace'])}")
    print(f"dist: the trajectory against one process's on the card: losses max rel diff {loss_rel:.3g} (bound "
          f"1e-4); parameters after step {DIST_STEPS}: {show(params)}; ranks' parameters bit-equal: "
          f"{ranks_equal}. Not held, two one-process runs against each other: losses {again_rel:.3g}, parameters "
          f"{show(worst_rel(again_params, one_params), False)}; the updates (parameters after step {DIST_STEPS} "
          f"less the start), ranks against one process {show(worst_rel(updates(dp_params), updates(one_params)), False)}, "
          f"one process against itself {show(worst_rel(updates(again_params), updates(one_params)), False)}")
    failures = []
    if (loss_rel > 1e-4 or not ranks_equal or beyond(params) or len(same_state) != DIST_STEPS
            or any(s["losses"] > 1e-4 or beyond(s["gradients"]) or beyond(s["trace"]) for s in same_state)):
        failures.append(f"data-parallel train parity beyond its bounds: losses {loss_rel}, parameters {params}, "
                        f"ranks equal {ranks_equal}, steps from the same state {same_state}")

    bn_same = ranks[0]["bn_same_state"]
    bn_equal = ranks[0]["bn_losses"] == ranks[1]["bn_losses"] and ranks[1]["bn_unequal_to_rank0"] == 0
    print(f"dist: train_bn, global batch statistics (each batch norm's (sum x, sum x^2) all-reduced, its backward "
          f"too), 2 ranks over {ranks[0]['backend']} on cuda:0, {BN_STEPS} f32 SGD steps, the same widths and "
          f"batches [{card_name}]")
    for k, st in enumerate(bn_same):
        print(f"dist: train_bn step {k + 1} against one process's step on the global batch from the same state: "
              f"losses max rel diff {st['losses']:.3g} (bound 1e-4); gradients' worst relative L2 error: "
              f"{show(st['gradients'], bounds=DIST_BN_GRAD_BOUNDS)}; of the optimizer's trace: "
              f"{show(st['trace'], bounds=DIST_BN_GRAD_BOUNDS)}; committed running statistics {st['stats']:.3g} of "
              f"their scale (bound {BN_STATS_BOUND:g})")
    bn_layer = ranks[0]["bn_layer"]
    print(f"dist: train_bn, the batch norm layer alone at the stem's shape, 2 ranks (4 images each) against one "
          f"process (8), largest difference of the reference's max-abs: "
          + ", ".join(f"{k} {v:.3g}" for k, v in bn_layer.items()) + f" (bound {BN_LAYER_BOUND:g})")
    bn_t = [r["bn_timing"] for r in ranks]
    print(f"dist: train_bn ranks' parameters and statistics bit-equal: {bn_equal}; step ms per rank "
          f"{[round(t['step_ms'], 2) for t in bn_t]} (median of {BN_TIMED}, host clock, synchronized); with the "
          f"statistics' all-reduces timed one by one: {bn_t[0]['reduces']} all-reduces a step (forward and "
          f"backward), {[round(t['reduce_ms'], 2) for t in bn_t]} ms a step of them per rank, step "
          f"{[round(t['instrumented_step_ms'], 2) for t in bn_t]} ms [{card_name}]")
    if (not bn_equal or len(bn_same) != BN_STEPS or len(bn_layer) != 4
            or any(v > BN_LAYER_BOUND for v in bn_layer.values())
            or any(st["losses"] > 1e-4 or beyond(st["gradients"], DIST_BN_GRAD_BOUNDS)
                   or beyond(st["trace"], DIST_BN_GRAD_BOUNDS) or st["stats"] > BN_STATS_BOUND for st in bn_same)
            or any(c != 2 * 110 for c in bn_t[0]["reduces"])):
        failures.append(f"data-parallel train_bn beyond its bounds: ranks equal {bn_equal}, the layer {bn_layer}, "
                        f"steps from the same state {bn_same}, all-reduces a step {bn_t[0]['reduces']} (expected 2 x 110)")

    timed = [r["timed"] for r in ranks]
    print(f"dist: data-parallel timing, {DIST_TIMED} bf16 Adam steps of the training flagship through the RPN "
          f"path (2000 post-NMS proposals), 4 images per rank: step ms per rank "
          f"{[round(t['step_ms'], 2) for t in timed]} (median of steps 3-{DIST_TIMED}, CUDA events), gradient "
          f"all-reduce {[round(t['reduce_ms'], 2) for t in timed]} ms of {timed[0]['reduce_mb']:.1f} MB (Gloo, "
          f"the CUDA buckets as they are), host batch {[round(t['data_ms'], 2) for t in timed]} ms per rank "
          f"(each makes the global batch of 8 and keeps its 4); one process at batch 4 on the card alone: step "
          f"{one_timed['step_ms']:.2f} ms, host batch {one_timed['data_ms']:.2f} ms. NOT a scaling figure: the "
          f"two ranks share one card [{card_name}]")
    if abs(timed[0]["last_loss"] - timed[1]["last_loss"]) > 0:
        failures.append(f"the ranks' global losses differ: {timed}")

    # one NCCL rank: the backend comes up and the all-reduce path runs
    import torch.distributed as dist

    from caesar_mrcnn_tpu_torch.parallel import dist as D

    backend = D.init_process_group(0, 1, "cuda:0", port=free_port(), timeout_s=300.0)
    try:
        nccl = _timed_train(ds_paths, train_config(images_per_device=4), dist.group.WORLD, 0, 1,
                            torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    print(f"dist: one {backend} rank (world size 1): train step {nccl['step_ms']:.2f} ms, all-reduce "
          f"{nccl['reduce_ms']:.2f} ms of {nccl['reduce_mb']:.1f} MB; losses "
          f"{nccl['first_loss']:.4f} -> {nccl['last_loss']:.4f} [{card_name}]")
    if backend != "nccl":
        failures.append(f"the one-card rank came up on {backend}, not NCCL")

    diffs = catalog_differences(catalogs["one", "f32"], catalogs["two", "f32"])
    bf16 = catalogs["two", "bf16"]
    no_polygon = check_catalog_files(bf16, bf16, regions, 2048, 2048)
    print(f"dist: multi-process catalog, SFinder.run_tiled on 2 Gloo ranks (cuda:0): f32 pinned heads, 4 tiles of the "
          f"seeded 1024^2 mosaic: {len(catalogs['two', 'f32']['objs'])} sources, {len(diffs)} differences from the "
          f"one-process catalog (exact); bf16 flagship, 16 tiles of the seeded 2048^2 mosaic: {len(bf16['objs'])} "
          f"sources ({no_polygon} without a DS9 polygon; one process: {len(catalogs['one', 'bf16']['objs'])}), "
          f"wall per rank {[round(r['catalog_s']['bf16'], 2) for r in ranks]} s, one process "
          f"{one_catalog_s['bf16']:.2f} s; catalog files checked [{card_name}]")
    if diffs or not catalogs["two", "f32"]["objs"]:
        failures.append("the two-process f32 catalog differs:\n" + "\n".join(diffs[:20]))

    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    # per rank: the parity steps (given ROIs: no NMS), the train_bn steps (given ROIs), the timed steps, one
    # batch of each catalog
    train_steps = DIST_STEPS + BN_STEPS + 2 * BN_TIMED + DIST_TIMED
    per_rank = {"nms": DIST_TIMED + 4, "roi_align": 2 * train_steps + 4, "roi_align_backward": 2 * train_steps,
                "crop_and_resize": train_steps}
    if any(r["launches"] != per_rank for r in ranks):
        failures.append(f"launches per rank {[r['launches'] for r in ranks]}, expected {per_rank}")
    detect, detect_inputs = check_dist_detect(card_name)
    launches = {k: launches[k] + detect.get(k, 0) for k in launches}

    seen = []

    class Capture(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    from caesar_mrcnn_tpu_torch.inference import detector as TD

    handler = Capture(logging.WARNING)
    TD.log.addHandler(handler)
    try:
        shrunk = TD.build_detector(flagship_config(num_devices=2, images_per_device=1, compute_dtype="float32"),
                                   seed=SEED, device="cuda")
    finally:
        TD.log.removeHandler(handler)
    print(f"dist: build_detector(num_devices=2) on {torch.cuda.device_count()} card(s): num_devices "
          f"{shrunk.config.num_devices}, batch {shrunk.config.batch_size}; warning: {seen} [{card_name}]")
    if torch.cuda.device_count() == 1 and (shrunk.config.num_devices != 1 or not seen):
        failures.append("build_detector did not shrink to the one card")
    print(f"dist: phase {time.perf_counter() - t0:.2f} s (the spawned ranks {spawn_s:.2f} s); launches {launches} "
          f"[{card_name}]")
    if failures:
        raise AssertionError("dist: " + "\ndist: ".join(failures))
    # after the path's launches were read
    check_dist_kernels(kernel_inputs, detect_inputs, recs, card_name)
    return launches


def check_dist_kernels(rank_inputs: dict, detect_inputs: dict, recs: dict, card_name: str) -> None:
    """The kernels against their plain versions on the inputs that the dist
    path gave them: rank 0's first parity step (f32, 4 images of 256^2,
    given ROIs: the ROIAlign forward at pool 7 and 14, its backward on the
    gradients that reached those outputs, the mask-target crop), its first
    timed step (bf16, the RPN path: NMS as well), its first ``train_bn``
    step (f32, global batch statistics, given ROIs) and replica 0's step of
    the two-replica detect (f32, one 512^2 tile: the RPN's and the
    per-class NMS, ROIAlign at pool 7 and 14)."""
    check_captured_kernels(
        {"DP rank parity step": rank_inputs["parity"], "DP rank timed step": rank_inputs["timed"],
         "DP rank train_bn step": rank_inputs["train_bn"], "2-replica detect": detect_inputs},
        {"DP rank parity step": (0, 2, 1), "DP rank timed step": (1, 2, 1), "DP rank train_bn step": (0, 2, 1),
         "2-replica detect": (2, 2, 0)}, recs, card_name, "dist")


def check_captured_kernels(cases: dict, expected: dict, recs: dict, card_name: str, phase: str) -> None:
    """Each kernel against its plain version on the inputs a path gave it
    (``cases``: label -> :meth:`KernelInputs.inputs`), whose NMS, ROIAlign
    and crop calls are ``expected`` (label -> counts). A case with a crop is
    a train step: a gradient must have reached each ROIAlign output, and
    the backward is checked on it. The tolerances of the seeded cases: NMS
    exact; the ROIAlign forward within 1 bf16 ulp, at f32 within 1e-5 of
    the element's absolute-contribution sum; the backward and the crop as
    there."""
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_levels

    for label, cap in cases.items():
        got = (len(cap["nms"]), len(cap["roi_align"]), len(cap["crop"]))
        if got != expected[label]:
            raise AssertionError(f"{phase}: {label} kept {got} NMS, ROIAlign and crop inputs, expected "
                                 f"{expected[label]}")
        for boxes, scores, max_out, thr in cap["nms"]:
            nms_against_plain(recs["nms"], boxes.cuda(), scores.cuda(), max_out, thr, label, card_name)
        for entry in cap["roi_align"]:
            (image, width), pool = entry["image"], entry["pool"]
            levels, boxes = [f.cuda() for f in entry["levels"]], entry["boxes"].cuda()
            if image != width:
                raise AssertionError(f"{phase}: {label} ROIAlign at {image}x{width}")
            per_level = roi_levels(boxes, float(image * width)).flatten().long().bincount(minlength=4).tolist()
            print(f"kernels: {label} ROIs at pool {pool}: {tuple(boxes.shape[:2])}, per level P2..P5 {per_level}")
            roi_align_against_plain(recs["roi_align"], levels, boxes, image, pool, label, card_name)
            if "grad" in entry:
                backward_against_plain(recs["roi_align_backward"], entry["grad"].cuda(), boxes, label, card_name)
            elif expected[label][2]:
                raise AssertionError(f"{phase}: {label} ROIAlign at pool {pool}: no gradient reached its output")
        for masks, dtype, boxes, assign, crop in cap["crop"]:
            crop_against_plain(recs["crop_and_resize"], masks.cuda().to(dtype), boxes.cuda(), assign.cuda(), crop,
                               label, card_name)


def check_dist_detect(card_name: str) -> tuple:
    """The Detector over two devices from one process, both ``cuda:0`` (two
    replicas, f32, one tile each) against the one-device Detector on the
    same batch of two tiles: detections within 1e-5. Returns its launches
    and the kernel inputs of replica 0's step."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.inference.detector import Detector
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.testing import compare_detections

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        write_mosaic(path)
        tiles = read_tiles(path, 2048, 512)[4:6]
    cfg = flagship_config(images_per_device=1, num_devices=2, compute_dtype="float32")
    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(SEED))
    settle_random_weights(model)
    two = Detector(cfg, model, [torch.device("cuda", 0)] * 2)
    _zero_launches()
    with KernelInputs() as captured:
        captured.on = True
        got = two.fetch(two.dispatch_tiles(tiles))
    launches = _launches()
    one = Detector(cfg.replace(images_per_device=2, num_devices=1), model, "cuda")
    ref = one.fetch(one.dispatch_tiles(tiles))
    worst = {"compared": 0, "unmatched": 0, "class_mismatch": 0, "max_scores_diff": 0.0, "max_boxes_diff": 0.0}
    for i in range(2):
        raw = [{"boxes": d[i][d[i][:, 4] > 0][:, :4], "class_ids": d[i][d[i][:, 4] > 0][:, 4],
                "scores": d[i][d[i][:, 4] > 0][:, 5]} for d in (ref[0], got[0])]
        cmp = compare_detections(*raw)
        for k in worst:
            worst[k] = worst[k] + cmp[k] if k in ("compared", "unmatched", "class_mismatch") else max(worst[k], cmp[k])
    print(f"dist: Detector over [cuda:0, cuda:0] (two replicas, f32, one 512^2 tile each) vs the one-device "
          f"Detector on the same 2 tiles: {worst['compared']} isolated detections compared, {worst['unmatched']} "
          f"unmatched, max score diff {worst['max_scores_diff']:.3g}, max box diff {worst['max_boxes_diff']:.3g} "
          f"(bound 1e-5); launches {launches} [{card_name}]")
    if (worst["compared"] == 0 or worst["unmatched"] or worst["class_mismatch"]
            or worst["max_scores_diff"] > 1e-5 or worst["max_boxes_diff"] > 1e-5):
        raise AssertionError(f"dist: two-replica detect differs from the one-device Detector: {worst}")
    if launches != {"nms": 4, "roi_align": 4, "roi_align_backward": 0, "crop_and_resize": 0}:
        raise AssertionError(f"dist: two-replica detect launches {launches}, expected 2 NMS and 2 ROIAlign per replica")
    if len(captured.nms) != 4 or len(captured.roi_align) != 4:
        raise AssertionError(f"dist: two-replica detect kept {len(captured.nms)} NMS and {len(captured.roi_align)} "
                             "ROIAlign inputs, expected 4 and 4")
    # replica 0's step is enqueued first: its RPN NMS, ROIAlign at pool 7, per-class NMS, ROIAlign at pool 14
    return launches, {"nms": captured.nms[:2], "roi_align": captured.roi_align[:2], "crop": []}


# ---------------------------------------------------------------------- cli


class TimedSteps:
    """``trainer.make_train_step`` for the CLI's run, each step's losses
    kept and its device time taken by CUDA events around the call."""

    def __init__(self, make_train_step):
        self.make_train_step = make_train_step
        self.events, self.losses = [], []

    def __call__(self, *args, **kwargs):
        import torch

        step = self.make_train_step(*args, **kwargs)

        def timed(batch, *a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses = step(batch, *a, **kw)
            end.record()
            self.events.append((start, end))
            self.losses.append(losses)
            return losses

        return timed

    def summary(self):
        """(median step ms of the steps after the first two, first and last
        total loss, every loss finite)."""
        import torch

        torch.cuda.synchronize()
        ms = statistics.median(s.elapsed_time(e) for s, e in self.events[2:])
        totals = [float(l["total_loss"]) for l in self.losses]
        finite = all(bool(torch.isfinite(v)) for l in self.losses for v in l.values())
        return ms, totals[0], totals[-1], finite


def run_cli(argv, counters) -> tuple:
    """``cli.run.main(argv)``, which must return 0: (wall seconds, launches)."""
    import torch

    from caesar_mrcnn_tpu_torch.cli import run as cli

    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    t = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return wall, {k.__name__: k.launches for k in counters}


def check_cli(card_name: str) -> dict:
    """The port's CLI on the card, as a user runs it: train, a resume with
    gradient accumulation, test and tiled detect, each through
    ``cli.run.main`` with the CLI's defaults for everything not named."""
    from caesar_mrcnn_tpu_torch.config import detector_config
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.quant import conv2d_int8, quantize_int8
    from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align, roi_align_backward
    from caesar_mrcnn_tpu_torch.train import trainer as T
    from caesar_mrcnn_tpu_torch.train.checkpoints import checkpoint_name

    counters = (nms_padded, roi_align, roi_align_backward, crop_and_resize, conv2d_int8, quantize_int8)
    no_int8 = {"conv2d_int8": 0, "quantize_int8": 0}
    name = detector_config().name  # the CLI's checkpoints are mask_rcnn_<name>_NNNN.pt
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # SFinder writes its DS9 file to the working directory
        make_train_step = T.make_train_step
        try:
            datalist = os.path.join(tmp, "train.list")
            with open(datalist, "w") as f:
                f.write("\n".join(write_train_dataset(tmp)) + "\n")
            mosaic = os.path.join(tmp, "mosaic.fits")
            write_mosaic(mosaic)
            logs = os.path.join(tmp, "logs")
            data = ["--dataloader", "datalist_json", "--imgsize", "256", "--nimg_per_gpu", "8", "--logs", logs]
            train = ["train", "--datalist_train", datalist, "--datalist_val", datalist, "--nepochs", "1",
                     "--nvalidation_steps", "2", "--no_augmentation"] + data
            runs = {}
            for mode, argv, steps in (("train", train + ["--epoch_length", "10"], 10),
                                      ("resume", train + ["--weights", os.path.join(logs, checkpoint_name(name, 1) + ".pt"),
                                                          "--epoch_length", "4", "--grad_accum_steps", "2"], 4)):
                T.make_train_step = timed = TimedSteps(make_train_step)
                wall, launches = run_cli(argv, counters)
                T.make_train_step = make_train_step
                ms, first, last, finite = timed.summary()
                # per micro-step 1 NMS, 2 ROIAlign forward and backward, 1 crop;
                # per validation step the same without the backward
                expected = {"nms_padded": steps + 2, "roi_align": 2 * (steps + 2),
                            "roi_align_backward": 2 * steps, "crop_and_resize": steps + 2, **no_int8}
                if launches != expected:
                    raise AssertionError(f"cli {mode} launches {launches}, expected {expected}")
                if not finite:
                    raise AssertionError(f"cli {mode}: non-finite losses")
                runs[mode] = (wall, launches)
                print(f"cli: {mode} ({steps} micro-steps, 2 validation steps, ResNet-101 256^2 batch 8 bf16, "
                      f"{'grad_accum_steps 2' if mode == 'resume' else 'Adam'}): {wall:.2f} s wall; step "
                      f"{ms:.2f} ms (median of steps 3-{steps}, CUDA events); total_loss first {first:.4f}, last "
                      f"{last:.4f}; launches {launches} [{card_name}]")
            ckpt = os.path.join(logs, checkpoint_name(name, 2) + ".pt")
            if not os.path.isfile(ckpt):
                raise AssertionError(f"the resume wrote no {os.path.basename(ckpt)}")
            scores = ["--scoreThr", "0.0", "--scoreThrPerClass", "none", "--weights", ckpt]
            # two batches each; with --serving, 123 int8 convs and quantizers per
            # batch, and one NMS and ROIAlign pair more each for the calibration
            float_launches = {"nms_padded": 4, "roi_align": 4, "roi_align_backward": 0, "crop_and_resize": 0,
                              **no_int8}
            serving_launches = {**float_launches, "nms_padded": 6, "roi_align": 6,
                                "conv2d_int8": 2 * INT8_SITES, "quantize_int8": 2 * INT8_QUANTIZERS}
            for mode, serving in (("test", []), ("test --serving", ["--serving"])):
                wall, launches = run_cli(["test", "--datalist", datalist] + scores + data + serving, counters)
                with open(os.path.join(logs, "map_summary.json")) as f:
                    summary = json.load(f)
                expected = serving_launches if serving else float_launches
                if launches != expected:
                    raise AssertionError(f"cli {mode} launches {launches}, expected {expected}")
                runs[mode] = (wall, launches)
                print(f"cli: {mode} on the 16 images, batch 8: {wall:.2f} s wall; map_summary.json "
                      f"{json.dumps(summary)[:300]}; launches {launches} [{card_name}]")
            for mode, serving in (("detect", []), ("detect --serving", ["--serving"])):
                catalog_path = os.path.join(tmp, "catalog.json")
                wall, launches = run_cli(["detect", "--image", mosaic, "--split_img_in_tiles", "--tile_xsize", "512",
                                          "--tile_ysize", "512", "--nimg_per_gpu", "8", "--detect_outfile_json",
                                          catalog_path] + scores + serving, counters)
                expected = serving_launches if serving else float_launches
                if launches != expected:
                    raise AssertionError(f"cli {mode} launches {launches}, expected {expected}")
                with open(catalog_path) as f:
                    catalog = json.load(f)
                with open(os.path.join(tmp, "ds9_mosaic.reg")) as f:
                    regions = f.read()
                if catalog["objs"]:
                    check_catalog_files(catalog, catalog, regions, 2048, 2048)
                runs[mode] = (wall, launches)
                print(f"cli: {mode} on the 2048^2 mosaic, 16 tiles of 512^2, batch 8: {wall:.2f} s wall; "
                      f"{len(catalog['objs'])} sources; catalog JSON and DS9 file read back; launches {launches} "
                      f"[{card_name}]")
        finally:
            T.make_train_step = make_train_step
            os.chdir(cwd)
    for name, k in (("nms", "nms_padded"), ("roi_align", "roi_align"), ("roi_align_backward", "roi_align_backward"),
                    ("crop_and_resize", "crop_and_resize"), ("conv2d_int8", "conv2d_int8"),
                    ("quantize_int8", "quantize_int8")):
        out[name] = sum(launches[k] for _, launches in runs.values())
    print(f"cli: {sum(w for w, _ in runs.values()):.2f} s over the {len(runs)} calls [{card_name}]")
    return out


# ----------------------------------------------------------------- classify

SKY_TILES = 4  # samples per side of the classify phase's sky
SKY_SAMPLE = 256  # side of each SkySimulator sample


def write_sky(path: str, seed: int = SEED) -> list:
    """A seeded 1024^2 synthetic sky for the classify phase, written to
    ``path`` as FITS: 4 x 4 ``SkySimulator`` samples of 256^2 side by side
    (each brings its own beam, noise and ~5 objects, where one 1024^2
    sample brings as many in all). Returns its objects in the sky's frame:
    (class, x0, y0, xmin, xmax, ymin, ymax), the centroid the mask's mean
    pixel and the box its extent (max + 1)."""
    from caesar_mrcnn_tpu_torch.data.synthetic import SkySimulator
    from caesar_mrcnn_tpu_torch.utils.fits import write_fits

    sim = SkySimulator(size=SKY_SAMPLE, seed=seed)
    n = SKY_TILES * SKY_SAMPLE
    img = np.zeros((n, n), np.float32)
    objs = []
    for i in range(SKY_TILES):
        for j in range(SKY_TILES):
            y, x = i * SKY_SAMPLE, j * SKY_SAMPLE
            sample, sample_objs = sim.sample()
            img[y:y + SKY_SAMPLE, x:x + SKY_SAMPLE] = sample
            for o in sample_objs:
                ys, xs = np.nonzero(o["mask"])
                objs.append((o["class"], x + float(xs.mean()), y + float(ys.mean()), x + int(xs.min()),
                             x + int(xs.max()) + 1, y + int(ys.min()), y + int(ys.max()) + 1))
    write_fits(img, path, header={"BMAJ": 1.5e-3, "BMIN": 1.2e-3, "CDELT1": -2.8e-4, "CDELT2": 2.8e-4})
    return objs


def write_scatalog(path: str, objs: list) -> list:
    """The objects as a Caesar ascii catalog in ``SClassifier.read_scatalog``'s
    17 columns (name at 0, centroid at 5/6, box at 13-16), every one of them:
    the port clamps a cutout at the left or top edge to the image (ROADMAP
    C9). Returns the names written."""
    names = []
    with open(path, "w") as f:
        f.write("# name ... x0 y0 ... xmin xmax ymin ymax\n")
        for k, (_, x0, y0, xmin, xmax, ymin, ymax) in enumerate(objs):
            names.append(f"SKY{k:03d}")
            f.write(" ".join([names[-1]] + ["0"] * 4 + [f"{x0:.2f}", f"{y0:.2f}"] + ["0"] * 6
                             + [str(xmin), str(xmax), str(ymin), str(ymax)]) + "\n")
    return names


def classifier_weights(path: str, cutout: int, pinned: bool) -> None:
    """Seeded random weights of the classifier CLI's model (its default
    4+1 classes), settled as ``settle_random_weights`` settles the
    flagship's (stem / 255, background bias -3), optionally with pinned
    heads (``testing.pin_heads``), saved as a ``.pt`` checkpoint."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.cli.sclassifier import DEFAULT_CLASSDICT
    from caesar_mrcnn_tpu_torch.config import detector_config
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.testing import pin_heads

    model = MaskRCNN(detector_config(num_classes=len(json.loads(DEFAULT_CLASSDICT)) + 1,
                                     image_min_dim=cutout, image_max_dim=cutout))
    W.init_weights(model, torch.Generator().manual_seed(SEED))
    settle_random_weights(model)
    if pinned:
        pin_heads(model)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def read_sclass_catalog(path: str) -> list:
    """The classification catalog's rows: (name, x0, y0, class_id,
    class_name, score)."""
    with open(path) as f:
        lines = f.read().splitlines()
    if lines[0] != "# name x0 y0 class_id class_name score":
        raise AssertionError(f"catalog header {lines[0]!r}")
    rows = []
    for line in lines[1:]:
        name, x0, y0, cid, cname, score = line.split()
        rows.append((name, float(x0), float(y0), int(cid), cname, float(score)))
    return rows


def run_sclassifier(argv) -> tuple:
    """``cli.sclassifier.main(argv)``, which must return 0: (wall seconds,
    launches, the wall ms of each model build, cutout, detect call (H2D,
    the detect step, the fetch and the host unmold) and Analyzer pass)."""
    import torch

    from caesar_mrcnn_tpu_torch.analysis.analyzer import Analyzer
    from caesar_mrcnn_tpu_torch.analysis.classifier import SClassifier
    from caesar_mrcnn_tpu_torch.cli import sclassifier
    from caesar_mrcnn_tpu_torch.inference import detector
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    nms_padded.launches = roi_align.launches = 0
    targets = {"build": (detector, "build_detector"), "cutout": (SClassifier, "_make_cutout"),
               "detect": (detector.Detector, "detect"), "analyzer": (Analyzer, "extract_det_masks")}
    with MethodTimer(targets) as spans:
        t = time.perf_counter()
        rc = sclassifier.main(argv)
        wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"sclassifier returned {rc}")
    return wall, {"nms": nms_padded.launches, "roi_align": roi_align.launches}, spans.ms


def check_classify_kernels(det, sky: str, cat: str, recs: dict, card_name: str) -> None:
    """NMS and the ROIAlign forward against their plain versions on the
    inputs of one ``Detector.detect`` call of the classify path (the
    detector the CLI built, on the cutout of the catalog's first source, as
    ``SClassifier.run`` makes it): the RPN's 6000 boxes before NMS, the
    class-offset boxes of the per-class NMS, and the real bf16 P2..P5 of
    the cutout with its proposals (pool 7) and detections (pool 14); the
    same tolerances as the seeded cases (exact; 1 bf16 ulp)."""
    import torch

    from caesar_mrcnn_tpu_torch.analysis.classifier import SClassifier
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_levels

    sc = SClassifier(det, det.config)
    sc.scutout_size = det.config.image_min_dim
    if sc.read_img(sky) or sc.read_scatalog(cat):
        raise AssertionError("the classify sky or catalog did not read back")
    cutout = sc._make_cutout(sc.sources[0])
    with KernelInputs() as inputs:
        inputs.on = True
        det.detect([cutout])
    if len(inputs.nms) != 2 or len(inputs.roi_align) != 2:
        raise AssertionError(f"one classify detect made {len(inputs.nms)} NMS and "
                             f"{len(inputs.roi_align)} ROIAlign calls, expected 2 and 2")
    print(f"kernels: classify inputs: one Detector.detect of the classify path on {sc.sources[0].name}'s "
          f"cutout {cutout.shape[:2]} [{card_name}]")
    for (boxes, scores, max_out, thr), label in zip(inputs.nms, ("classify RPN", "classify per-class")):
        nms_against_plain(recs["nms"], boxes.cuda(), scores.cuda(), max_out, thr, label, card_name)
    for entry in inputs.roi_align:
        levels, boxes, (image, width), pool = ([f.cuda() for f in entry["levels"]], entry["boxes"].cuda(),
                                               entry["image"], entry["pool"])
        if image != width or any(f.dtype != torch.bfloat16 for f in levels):
            raise AssertionError(f"classify ROIAlign at {image}x{width}, levels {[f.dtype for f in levels]}")
        per_level = torch.bincount(roi_levels(boxes, float(image * width)).flatten().long(), minlength=4).tolist()
        print(f"kernels: classify boxes at pool {pool}: {tuple(boxes.shape[:2])}, per level P2..P5 {per_level}")
        roi_align_against_plain(recs["roi_align"], levels, boxes, image, pool, "classify", card_name)


def check_classify(recs: dict, card_name: str) -> dict:
    """Source classification through the port's classifier CLI on the card
    (module docstring, phase 14): a seeded synthetic sky and its catalog,
    256^2 cutouts at the serving flagship's width and batch 1; the kernels
    on one of its detect calls' inputs; then the card-against-CPU parity at
    f32 with pinned heads."""
    from caesar_mrcnn_tpu_torch.cli import sclassifier
    from caesar_mrcnn_tpu_torch.inference import detector

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            sky = os.path.join(tmp, "sky.fits")
            objs = write_sky(sky)
            cat = os.path.join(tmp, "sky_catalog.dat")
            names = write_scatalog(cat, objs)
            weights = os.path.join(tmp, "classifier.pt")
            classifier_weights(weights, 256, pinned=False)
            out = os.path.join(tmp, "sclass.dat")
            argv = ["--image", sky, "--scatalog", cat, "--scutout_size", "256", "--device", "cuda",
                    "--weights", weights, "--scoreThr", "0.3", "--iouThr", "0.3", "--outfile", out]
            built, build = [], detector.build_detector
            detector.build_detector = lambda *a, **kw: built.append(build(*a, **kw)) or built[-1]
            try:
                wall, launches, spans = run_sclassifier(argv)
            finally:
                detector.build_detector = build
            cutouts = len(spans["cutout"])
            if launches != {"nms": 2 * cutouts, "roi_align": 2 * cutouts} or len(spans["detect"]) != cutouts:
                raise AssertionError(f"classify launches {launches} over {cutouts} cutouts ({len(spans['detect'])} "
                                     f"detect calls), expected 2 NMS and 2 ROIAlign per cutout")
            rows = read_sclass_catalog(out)
            classes = set(json.loads(sclassifier.DEFAULT_CLASSDICT))
            classified = [r for r in rows if r[3] != -1]
            if [r[0] for r in rows] != names or not 0 < cutouts <= len(names):
                raise AssertionError(f"{len(rows)} catalog rows for {len(names)} sources, {cutouts} cutouts")
            edge = sum(x0 < 128 or y0 < 128 for _, x0, y0, *_ in objs)
            bad = [r for r in classified if r[4] not in classes or not (0.3 <= r[5] <= 1.0)]
            if bad:
                raise AssertionError(f"classified rows with an unknown class or a score outside [0.3, 1]: {bad[:5]}")
            print(f"classify: cli.sclassifier.main on a seeded {SKY_TILES * SKY_SAMPLE}^2 synthetic sky ({SKY_TILES} x "
                  f"{SKY_TILES} SkySimulator samples, "
                  f"{len(objs)} objects, all in the catalog; {edge} within 128 px of the left or top edge, their "
                  f"cutouts clamped to the image, ROADMAP C9), 256^2 cutouts, ResNet-101 FPN 256 bf16 batch 1, 4+1 "
                  f"classes, settled random weights, --scoreThr 0.3 --iouThr 0.3: {cutouts} cutouts run, "
                  f"{len(classified)} of {len(rows)} sources classified; launches {launches} (2 NMS and 2 ROIAlign "
                  f"per cutout) [{card_name}]")
            total = {k: sum(v) / 1e3 for k, v in spans.items()}
            print(f"classify: {wall:.2f} s wall, {1e3 * wall / cutouts:.1f} ms per cutout over the wall: model build "
                  f"and weights {total['build']:.2f} s; cutouts (crop, zscale) {total['cutout']:.2f} s; "
                  f"Detector.detect {total['detect']:.2f} s, {statistics.median(spans['detect']):.2f} ms per cutout "
                  f"(median; the first {spans['detect'][0]:.1f}); Analyzer.extract_det_masks {total['analyzer']:.2f} s, "
                  f"{statistics.median(spans['analyzer']):.2f} ms per cutout (median); the rest (FITS and catalog "
                  f"read, matching, writing) {wall - sum(total.values()):.2f} s [{card_name}]")
            for r in rows:
                print(f"classify: row {r[0]} {r[1]} {r[2]} {r[3]} {r[4]} {r[5]}")
            check_classify_kernels(built[0], sky, cat, recs, card_name)
            del built[:]

            # parity: f32, pinned heads, 128^2 cutouts, a handful of sources
            few = os.path.join(tmp, "few.dat")
            with open(cat) as f:
                lines = f.read().splitlines()
            with open(few, "w") as f:
                f.write("\n".join(lines[:7]) + "\n")  # the header and six sources
            pinned = os.path.join(tmp, "pinned.pt")
            classifier_weights(pinned, 128, pinned=True)
            make = sclassifier.detector_config
            sclassifier.detector_config = lambda **kw: make(**kw, compute_dtype="float32")
            try:
                got = {}
                for device in ("cuda", "cpu"):
                    path = os.path.join(tmp, f"few_{device}.dat")
                    argv = ["--image", sky, "--scatalog", few, "--scutout_size", "128", "--device", device,
                            "--weights", pinned, "--iouThr", "0.05", "--outfile", path]
                    seconds, _, few_spans = run_sclassifier(argv)
                    got[device] = (read_sclass_catalog(path), seconds, len(few_spans["cutout"]))
            finally:
                sclassifier.detector_config = make
        finally:
            os.chdir(cwd)
    (card, card_s, n), (cpu, cpu_s, _) = got["cuda"], got["cpu"]
    same = len(card) == len(cpu) and all(a[:5] == b[:5] and abs(a[5] - b[5]) <= 1e-5 for a, b in zip(card, cpu))
    n_classified = sum(r[3] != -1 for r in card)
    print(f"classify parity: the same CLI at f32 with pinned heads, 128^2 cutouts, {len(card)} sources, {n} cutouts, "
          f"--iouThr 0.05, card ({card_s:.2f} s) and --device cpu ({cpu_s:.2f} s): "
          + (f"{n_classified} classified" if n_classified else "pinned heads classified no source")
          + f"; rows {'equal' if same else 'DIFFERENT'} (names, positions, classes exactly, scores within 1e-5): "
          + "; ".join(f"{r[0]} {r[4]} {r[5]}" for r in card) + f" [{card_name}]")
    if not same:
        raise AssertionError(f"card and CPU classification catalogs differ:\n{card}\n{cpu}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the card")
    from caesar_mrcnn_tpu_torch import kernel_bench, native
    from caesar_mrcnn_tpu_torch.ops import _kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_name = kernel_bench.card()
    print(f"device: {card_name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"TF32 off for convolutions and matmuls")

    t = time.perf_counter()
    path, log = _kernels.build()
    _kernels.load(path)
    print(f"build: {os.path.relpath(path)} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():  # ptxas: each kernel's registers, shared memory, spills and warnings
        if any(w in line for w in ("registers", "Compiling entry", "spill", "arning")):
            print(f"build: {line.strip()}")
    t = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library (caesar_mrcnn_tpu_torch/native) did not build or load")
    print(f"build: native host library loaded, {os.path.relpath(native.library_path())} "
          f"({time.perf_counter() - t:.1f} s)")

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    nms = check_nms(dev, rng, card_name)
    roi = check_roi_align(dev, rng, card_name)
    roi_bwd = check_roi_align_backward(dev, rng, card_name)
    crop = check_crop_and_resize(dev, rng, card_name)
    conv8, conv8_library = check_conv_int8(dev, card_name)
    quant8 = check_quantize_int8(dev, rng, card_name)
    fold = check_fold_conv_bn(dev, card_name)
    torch.cuda.empty_cache()
    detect, path_batch = check_slice(card_name)
    paste = check_paste_masks(rng, path_batch, card_name)
    check_parity(card_name)
    catalog = check_catalog(card_name)
    check_catalog_parity(card_name)
    with tempfile.TemporaryDirectory() as tmp:
        ds_paths = write_train_dataset(tmp)
        ds = load_train_dataset(ds_paths)
        train, captured = check_train(ds, card_name)
        check_train_step_boxes(captured, {"nms": nms, "roi_align": roi, "roi_align_backward": roi_bwd,
                                          "crop_and_resize": crop}, card_name)
        check_train_parity(ds, card_name)
        torch.cuda.empty_cache()
        options = check_train_options(ds, {"nms": nms, "roi_align": roi, "roi_align_backward": roi_bwd,
                                           "crop_and_resize": crop}, card_name)
        torch.cuda.empty_cache()
        dist = check_dist(ds, ds_paths, {"nms": nms, "roi_align": roi, "roi_align_backward": roi_bwd,
                                         "crop_and_resize": crop}, card_name)
    torch.cuda.empty_cache()
    serving, serving_routes = check_serving(card_name)
    check_serving_parity(card_name)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    export = check_export(card_name)
    print(f"export: phase {time.perf_counter() - t:.2f} s [{card_name}]")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cli = check_cli(card_name)
    print(f"cli: phase {time.perf_counter() - t:.2f} s [{card_name}]")
    t = time.perf_counter()
    classify = check_classify({"nms": nms, "roi_align": roi}, card_name)
    print(f"classify: phase {time.perf_counter() - t:.2f} s [{card_name}]")
    print(f"launches: detect path {detect}, catalog path {catalog}, train path {train}, train options {options}, "
          f"dist {dist}, serving path {serving}, export path {export}, cli {cli}, classify {classify}")
    paths = (detect, catalog, train, options, dist, serving, export, cli, classify)

    def record(name, source, replaces, rec, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"caesar_mrcnn_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(p.get(name, 0) for p in paths),
                "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": max(rec["by"], key=rec["by"].get), "library_ms": library_ms,
                "library": NO_LIBRARY[name]}

    kernels = [
        record("nms", "nms.cu", "caesar_mrcnn_tpu/ops/nms.py:96", nms),
        record("roi_align", "roi_align.cu", "caesar_mrcnn_tpu/ops/roi_align_pallas.py:175", roi),
        record("roi_align_backward", "roi_align.cu", "caesar_mrcnn_tpu/ops/roi_align.py:114", roi_bwd),
        record("crop_and_resize", "crop_and_resize.cu", "caesar_mrcnn_tpu/ops/roi_align.py:43", crop),
        {**record("conv2d_int8", "conv_int8.cu", "caesar_mrcnn_tpu/models/backbone_int8.py:276", conv8,
                  conv8_library["ms"]),
         "library_sites": conv8_library["sites"], "ms_at_library_sites": conv8_library["kernel_ms"],
         "serving_routes": serving_routes},
        record("quantize_int8", "conv_int8.cu", "caesar_mrcnn_tpu/models/backbone_int8.py:272", quant8),
        record("paste_masks", "paste_masks.cu", "caesar_mrcnn_tpu/inference/detector.py:186", paste),
        record("fold_conv_bn", "fold_conv_bn.cu", "caesar_mrcnn_tpu/models/backbone_int8.py:93", fold),
    ]
    print(card_name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
