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
   operations over 67 TFLOP/s, whichever is larger) and the roofline share;
4. slice: the tiled detect path (``Detector.dispatch_tiles`` / ``collect``,
   two batches in flight) over 16 tiles of 512^2 read from a seeded 2048^2
   FITS mosaic, at the flagship's full width (ResNet-101, FPN 256, batch 8,
   bf16, 6000 pre-NMS / 1000 post-NMS / 100 detections);
5. parity: one tile at f32 through the card's detector and the same
   detector on the CPU, where the plain versions run;
6. train: 20 Adam steps of the training flagship (ResNet-101, FPN 256,
   256^2, batch 8, bf16, 2000 post-NMS proposals, 512 ROIs, 300 GT) on a
   seeded 16-image FITS dataset read through ``SourceDataset`` and the
   port's ``TrainingPipeline`` (compact wire); then NMS and the ROIAlign
   backward against their plain versions on the boxes of the last step
   (its RPN boxes before NMS, its sampled ROIs), which are saved to
   ``build/train_step_boxes.pt`` for ``caesar_mrcnn_tpu_torch/kernel_bench.py``;
7. train parity: one f32 SGD step of ResNet-101 at batch 2, 128^2, on the
   card and on the CPU from the same weights, batch and priorities: losses
   and gradients.

Then the card's name and power limit, one JSON line with the kernels'
record (launches on the main paths; error, kernel, plain and bound times
summed over the cases; ``library_ms`` null, with the reason beside it),
and as the last line
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
}


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


def check_roi_align(dev, rng, card_name: str) -> dict:
    import torch

    from caesar_mrcnn_tpu_torch.ops import roi_align as R

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    b, c = 8, 256
    rec = _record()
    # detect: 512^2, 1000 proposals at 7 and 100 detections at 14;
    # train: 256^2, 512 ROIs at 7 and the 168 positive slots at 14
    cases = [(512, n, pool) for n, pool in ((1000, 7), (100, 14))]
    cases += [(256, n, pool) for n, pool in ((512, 7), (168, 14))]
    levels = {}
    for image, n, pool in cases:
        if image not in levels:
            levels[image] = [
                torch.from_numpy(rng.randn(b, s, s, c).astype(np.float32)).to(dev, torch.bfloat16)
                for s in (image // 4, image // 8, image // 16, image // 32)
            ]
        lv = levels[image]
        boxes = torch.from_numpy(kb.roi_case(rng, b, n)).to(dev)

        def kernel():
            return R.roi_align(lv, boxes, (image, image), pool)

        def plain():
            return R.roi_align_plain(lv, boxes, (image, image), pool)

        k, p = kernel(), plain()
        torch.cuda.synchronize()
        diff = (k.float() - p.float()).abs()
        ulp = bf16_ulp(torch.maximum(k.float().abs(), p.float().abs()))
        if not bool((diff <= ulp).all()):
            raise AssertionError(f"roi_align {image}^2 N={n} pool={pool}: beyond 1 bf16 ulp, "
                                 f"max abs {float(diff.max())}")
        err = float(diff.max())
        ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 5)
        bound = kb.roi_align_bound(b, [tuple(f.shape[1:3]) for f in lv], n, pool, c, 2)
        print(f"kernels: roi_align bf16 {image}^2 B={b} N={n} pool={pool} C={c}: within 1 bf16 ulp "
              f"(max abs {err:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events); "
              f"{share(bound[0], ms)} ({bound[1]}) [{card_name}]")
        _add(rec, err, ms, plain_ms, bound)
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


def check_crop_and_resize(dev, rng, card_name: str) -> dict:
    """crop_and_resize against its plain version at the training flagship's
    shapes (f32 masks [8, 256, 256, 300], 168 positive ROIs): bit-equal."""
    import torch

    from caesar_mrcnn_tpu_torch.ops import roi_align as R

    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    b, h, g, r = 8, 256, 300, 168
    gen = torch.Generator(device=dev).manual_seed(SEED)
    masks = (torch.rand((b, h, h, g), generator=gen, device=dev) > 0.7).float()
    boxes = kb.roi_case(rng, b, r)
    boxes[:, 3] = [-0.1, 0.2, 0.5, 1.2]  # partly outside the map
    boxes = torch.from_numpy(boxes).to(dev)
    assign = torch.from_numpy(rng.randint(0, g, (b, r))).to(dev)

    def kernel():
        return R.crop_and_resize(masks, boxes, assign, (28, 28))

    def plain():
        return R.crop_and_resize_plain(masks, boxes, assign, (28, 28))

    k, p = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"crop_and_resize: {int((k != p).sum())} values differ from the plain version, "
                             f"max abs {float((k - p).abs().max())}")
    ms, plain_ms = kb.median_ms(kernel, kb.REPS), kb.median_ms(plain, 5)
    bound = kb.crop_and_resize_bound(b, r, 28, 28)
    print(f"kernels: crop_and_resize f32 masks [{b},{h},{h},{g}] R={r} 28x28: bit-equal; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms (median, CUDA events); {share(bound[0], ms)} ({bound[1]}) [{card_name}]")
    rec = _record()
    _add(rec, 0.0, ms, plain_ms, bound)
    return rec


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


def check_slice(card_name: str) -> dict:
    import torch

    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
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
    nms_padded.launches = roi_align.launches = 0
    results = run_pass(det, tiles)
    launches = {"nms": nms_padded.launches, "roi_align": roi_align.launches}
    if launches != {"nms": 2 * batches, "roi_align": 2 * batches}:
        raise AssertionError(f"kernel launches on the main path {launches}, expected 2 per batch x {batches}")
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

    run_pass(det, tiles)  # steady state
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
    return launches


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


def check_train(ds, card_name: str) -> dict:
    """20 Adam steps of the training flagship through the pipeline."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models import proposals as P
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
    # and the RPN's boxes and scores before its NMS, captured for the kernel
    # checks on a real step's boxes
    captured = {}

    def capture_nms(boxes, scores, *args):
        captured["nms"] = (boxes.clone(), scores.clone(), *args)
        return nms_padded(boxes, scores, *args)

    with torch.no_grad():
        b = T.mold_batch(batch, cfg)
        P.nms_padded = capture_nms
        try:
            out = forward_train(model, b["images"], b["gt_class_ids"], b["gt_boxes"], b["gt_masks"],
                                torch.from_numpy(pipe.anchors_normalized()).cuda(),
                                torch.tensor(cfg.rpn_bbox_std_dev, device="cuda"), generator=gen)
        finally:
            P.nms_padded = nms_padded
    pos_cap = int(cfg.train_rois_per_image * cfg.roi_positive_ratio)
    captured["rois"] = {cfg.pool_size: out.rois.contiguous(),
                        cfg.mask_pool_size: out.rois[:, :pos_cap].contiguous()}
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


def check_train_step_boxes(captured: dict, nms_rec: dict, bwd_rec: dict, card_name: str) -> None:
    """NMS and the ROIAlign backward on the boxes of a real flagship train
    step (its RPN boxes and scores before NMS; its 512 sampled ROIs at pool
    7 and 168 positive slots at pool 14, around 12 sources per image), which
    the seeded log-uniform boxes understate: these crowd onto P2. The boxes
    are saved for ``kernel_bench.py`` to ``build/train_step_boxes.pt``."""
    import torch

    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_levels

    boxes, scores, max_out, thr = captured["nms"]
    kb.TRAIN_STEP_BOXES.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"nms": (boxes.cpu(), scores.cpu(), int(max_out), float(thr)),
                "rois": {pool: rois.cpu() for pool, rois in captured["rois"].items()}}, kb.TRAIN_STEP_BOXES)
    nms_against_plain(nms_rec, boxes, scores, max_out, thr, "train-step RPN", card_name)
    rng = np.random.RandomState(SEED + 1)
    for pool, rois in captured["rois"].items():
        per_level = torch.bincount(roi_levels(rois, 256.0 * 256.0).flatten().long(), minlength=4).tolist()
        print(f"kernels: train-step ROIs at pool {pool}: {tuple(rois.shape[:2])}, per level P2..P5 {per_level}")
        grad = torch.from_numpy(rng.randn(*rois.shape[:2], pool, pool, 256).astype(np.float32))
        backward_against_plain(bwd_rec, grad.to(rois.device, torch.bfloat16), rois, "train-step", card_name)


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
    loss_rel = max(abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-12) for k in cl)
    bounds = {"backbone": 1e-2, "FPN and heads": 1e-3}
    worst = {group: (0.0, "") for group in bounds}
    for k, ref in cg.items():
        rel = float((gg[k] - ref).norm() / ref.norm().clamp_min(1e-30))
        group = "backbone" if k.startswith("backbone.") else "FPN and heads"
        worst[group] = max(worst[group], (rel, k))
    print(f"train parity: one f32 SGD step (learning rate {cfg.learning_rate}), ResNet-101 batch 2 128^2, card vs "
          f"CPU: losses max rel diff {loss_rel:.3g} (total {gl['total_loss']:.6f} / {cl['total_loss']:.6f}); "
          "gradients' worst relative L2 error: "
          + ", ".join(f"{group} {rel:.3g} ({k}; bound {bounds[group]:g})" for group, (rel, k) in worst.items())
          + f" [{card_name}]")
    if loss_rel > 1e-4 or any(worst[group][0] > bound for group, bound in bounds.items()):
        raise AssertionError(f"train parity beyond its bounds: losses {gl} vs {cl}; gradients {worst}")


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
    _kernels.library()
    print(f"build: {os.path.relpath(path)} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
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
    torch.cuda.empty_cache()
    detect = check_slice(card_name)
    check_parity(card_name)
    with tempfile.TemporaryDirectory() as tmp:
        ds = load_train_dataset(write_train_dataset(tmp))
        train, captured = check_train(ds, card_name)
        check_train_step_boxes(captured, nms, roi_bwd, card_name)
        check_train_parity(ds, card_name)
    print(f"launches: detect path {detect}, train path {train}")

    def record(name, source, replaces, rec):
        return {"name": name, "route": "cuda", "source": f"caesar_mrcnn_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": detect.get(name, 0) + train[name],
                "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": max(rec["by"], key=rec["by"].get), "library_ms": None,
                "library": NO_LIBRARY[name]}

    kernels = [
        record("nms", "nms.cu", "caesar_mrcnn_tpu/ops/nms.py:96", nms),
        record("roi_align", "roi_align.cu", "caesar_mrcnn_tpu/ops/roi_align_pallas.py:175", roi),
        record("roi_align_backward", "roi_align.cu", "caesar_mrcnn_tpu/ops/roi_align.py:114", roi_bwd),
        record("crop_and_resize", "crop_and_resize.cu", "caesar_mrcnn_tpu/ops/roi_align.py:43", crop),
    ]
    print(card_name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
