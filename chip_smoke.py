#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``caesar_mrcnn_tpu_torch``) on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases, one line each:

1. device: the card's name and power limit; TF32 is switched off;
2. build: the CUDA kernels, compiled from ``caesar_mrcnn_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the detect path gives it, with median times;
4. slice: the tiled detect path (``Detector.dispatch_tiles`` / ``collect``,
   two batches in flight) over 16 tiles of 512^2 read from a seeded 2048^2
   FITS mosaic, at the flagship's full width (ResNet-101, FPN 256, batch 8,
   bf16, 6000 pre-NMS / 1000 post-NMS / 100 detections);
5. parity: one tile at f32 through the card's detector and the same
   detector on the CPU, where the plain versions run.

Then one JSON line with the kernels' record, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result line. It needs a CUDA device and never falls
back to the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np

SEED = 0
CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flagship_config(**overrides):
    """The serving flagship: ResNet-101, 512^2, batch 8, bf16, 6000/1000."""
    from caesar_mrcnn_tpu.config import detector_config

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


# ------------------------------------------------------------------ kernels


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


def bf16_ulp(x):
    """One bf16 ulp at each value of the f32 tensor ``x`` (8 significant
    bits); 2^-133 at zero, so an exact zero must be matched exactly."""
    import torch

    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), torch.where(x == 0, -125, e) - 8)


def check_nms(dev, rng, card_name: str) -> dict:
    import torch

    from caesar_mrcnn_tpu_torch.ops import nms as N

    rec = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for b, n, thr, max_out, classes in ((8, 6000, 0.9, 1000, False), (8, 1000, 0.3, 300, True)):
        boxes, scores = (torch.from_numpy(a).to(dev) for a in nms_case(rng, b, n, classes))

        def kernel():
            return N.nms_padded(boxes, scores, max_out, thr)

        def plain():
            return N.nms_sorted_plain(*N.sort_boxes(boxes, scores), max_out, thr)

        ki, kv = kernel()
        pi, pv = plain()
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi.to(ki.dtype)) and torch.equal(kv, pv)):
            bad = int((ki != pi).sum() + (kv != pv).sum())
            raise AssertionError(f"nms {b}x{n} thr {thr}: {bad} entries differ from the plain version")
        ms, plain_ms = median_ms(kernel, 20), median_ms(plain, 3)
        print(f"kernels: nms B={b} N={n} thr={thr} max_output={max_out}: idx/valid equal "
              f"({int(kv.sum())} kept); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events) [{card_name}]")
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
    return rec


def check_roi_align(dev, rng, card_name: str) -> dict:
    import torch

    from caesar_mrcnn_tpu_torch.ops import roi_align as R

    b, c = 8, 256
    levels = [
        torch.from_numpy(rng.randn(b, s, s, c).astype(np.float32)).to(dev, torch.bfloat16)
        for s in (128, 64, 32, 16)
    ]
    rec = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for n, pool in ((1000, 7), (100, 14)):
        boxes = torch.from_numpy(roi_case(rng, b, n)).to(dev)

        def kernel():
            return R.roi_align(levels, boxes, (512, 512), pool)

        def plain():
            return R.roi_align_plain(levels, boxes, (512, 512), pool)

        k, p = kernel(), plain()
        torch.cuda.synchronize()
        diff = (k.float() - p.float()).abs()
        ulp = bf16_ulp(torch.maximum(k.float().abs(), p.float().abs()))
        if not bool((diff <= ulp).all()):
            raise AssertionError(f"roi_align N={n} pool={pool}: beyond 1 bf16 ulp, max abs {float(diff.max())}")
        err = float(diff.max())
        ms, plain_ms = median_ms(kernel, 20), median_ms(plain, 5)
        print(f"kernels: roi_align bf16 B={b} N={n} pool={pool} C={c}: within 1 bf16 ulp "
              f"(max abs {err:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events) [{card_name}]")
        rec["err"] = max(rec["err"], err)
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
    return rec


# -------------------------------------------------------------------- slice


def write_mosaic(path: str, n: int = 2048, seed: int = SEED) -> None:
    """Radio-looking n x n FITS mosaic: noise plus gaussian sources."""
    from caesar_mrcnn_tpu.utils.fits import write_fits

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
    from caesar_mrcnn_tpu.utils.fits import read_tile_u8
    from caesar_mrcnn_tpu.utils.tiles import generate_tiles

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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the card")
    from caesar_mrcnn_tpu_torch.ops import _kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_name = card()
    print(f"device: {card_name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"TF32 off for convolutions and matmuls")

    t = time.perf_counter()
    path, log = _kernels.build()
    _kernels.library()
    print(f"build: {os.path.relpath(path)} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"build: {line.strip()}")

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    nms = check_nms(dev, rng, card_name)
    roi = check_roi_align(dev, rng, card_name)
    launches = check_slice(card_name)
    check_parity(card_name)

    kernels = [
        {"name": "nms", "route": "cuda", "source": "caesar_mrcnn_tpu_torch/csrc/nms.cu",
         "replaces": "caesar_mrcnn_tpu/ops/nms.py:96", "launches": launches["nms"],
         "max_abs_err": nms["err"], "ms": nms["ms"], "plain_ms": nms["plain_ms"]},
        {"name": "roi_align", "route": "cuda", "source": "caesar_mrcnn_tpu_torch/csrc/roi_align.cu",
         "replaces": "caesar_mrcnn_tpu/ops/roi_align_pallas.py:175", "launches": launches["roi_align"],
         "max_abs_err": roi["err"], "ms": roi["ms"], "plain_ms": roi["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
