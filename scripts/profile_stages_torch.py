"""Per-stage profile of the PyTorch port's detect and train steps on one
CUDA card.

Run from the repository root on the machine with the card:

    python3 scripts/profile_stages_torch.py [--reps 20] [--out build/profile_stages.json]

Detect step, at the serving flagship (ResNet-101, FPN 256, 512^2, batch 8,
bf16, 6000 / 1000 proposals, 100 detections; settled random weights from
seed 0; 8 tiles of the seeded 2048^2 mosaic of ``chip_smoke.py``): the host
enqueue of ``Detector.dispatch_tiles`` (host clock, the call alone), the
H2D copy of the u8 tiles, the premold (cast, channels, mean), backbone +
FPN, RPN, proposals with NMS, ROIAlign at pool 7, the classifier head, the
refinement (per-class NMS), ROIAlign at pool 14, the mask head (and the
class mask's u8 wire), and the host unmold of a fetched batch
(``Detector.unmold_fetched``, host clock).

Train step, at the training flagship (ResNet-101, 256^2, batch 8, bf16,
Adam, 6000 / 2000 proposals, 512 ROIs, 300 GT; 16 seeded FITS images of 12
sources through ``TrainingPipeline``, the compact wire): the host batch
(``next`` of ``TrainingPipeline.batches``, host clock), ``batch_to_device``,
``mold_batch``, the forward with the losses, the backward, the optimizer.

Each device stage is timed by CUDA events around it (median of ``--reps``
runs after two warm-up runs), and its device kernels are summed by
``torch.profiler`` (a second pass of the same stage), with the largest
three by name. The stages that run a kernel of the port print the bound
``caesar_mrcnn_tpu_torch/kernel_bench.py`` computes for it on these inputs
(the least time the card could take for the kernel's work). ``--device
cpu`` rehearses the script's control flow on the CPU with host clocks; its
numbers are not device measurements.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class Clock:
    """Stage timer: CUDA events on the card, the host clock (synchronized)
    elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"

    def time(self, fn: Callable, reps: int, setup: Optional[Callable] = None):
        """(median ms of ``fn(setup())`` over ``reps`` runs, the last result)."""
        import torch

        out, times = None, []
        for i in range(reps + 2):
            arg = setup() if setup is not None else None
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = fn(arg) if setup is not None else fn()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                t = time.perf_counter()
                out = fn(arg) if setup is not None else fn()
                ms = 1e3 * (time.perf_counter() - t)
            if i >= 2:
                times.append(ms)
        return statistics.median(times), out

    def kernels(self, fn: Callable, reps: int, setup: Optional[Callable] = None):
        """(device ms per run of ``fn``, its three largest kernels as (name,
        ms per run)) from ``torch.profiler``; (None, []) off the card."""
        if not self.cuda:
            return None, []
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        args = [setup() if setup is not None else None for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for arg in args:
                fn(arg) if setup is not None else fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3 / reps) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        return sum(ms for _, ms in rows), [(k[:60], round(ms, 4)) for k, ms in rows[:3]]


def stage_row(name: str, ms: float, device_ms=None, top=(), bound=None, clock: str = "device") -> Dict:
    row = {"stage": name, "ms": round(ms, 4), "clock": clock}
    if device_ms is not None:
        row["kernels_ms"] = round(device_ms, 4)
        row["top_kernels"] = list(top)
    if bound is not None:
        row["bound_ms"], row["bound_by"] = round(bound[0], 4), bound[1]
    return row


def show(title: str, rows: List[Dict], card: str) -> None:
    print(f"{title} [{card}]")
    for r in rows:
        extra = ""
        if "kernels_ms" in r:
            extra += f"; device kernels {r['kernels_ms']:.3f} ms, largest {r['top_kernels']}"
        if "bound_ms" in r:
            extra += f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
        print(f"  {r['stage']:<26} {r['ms']:9.3f} ms ({r['clock']}){extra}")
    total = sum(r["ms"] for r in rows)
    print(f"  {'sum of the stages':<26} {total:9.3f} ms")


def nms_bound(module, fn: Callable):
    """``kernel_bench``'s NMS bound for the NMS call that ``fn`` makes
    through ``module.nms_padded``, from that call's own inputs and result."""
    from caesar_mrcnn_tpu_torch import kernel_bench as kb

    calls, real = [], module.nms_padded

    def spy(boxes, scores, max_out, thr):
        idx, valid = real(boxes, scores, max_out, thr)
        calls.append((scores, idx, valid, int(max_out)))
        return idx, valid

    module.nms_padded = spy
    try:
        fn()
    finally:
        module.nms_padded = real
    (scores, idx, valid, max_out), = calls
    b, n = scores.shape
    return kb.nms_bound(b, n, max_out, kb.nms_pairs(scores, idx, valid, max_out))


def profile_detect(device, reps: int, clock: Clock, card: str) -> List[Dict]:
    import torch

    import chip_smoke
    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.inference.detector import build_detector
    from caesar_mrcnn_tpu_torch.models import detection as D
    from caesar_mrcnn_tpu_torch.models import proposals as P
    from caesar_mrcnn_tpu_torch.models.detection import refine_detections
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import nhwc_levels
    from caesar_mrcnn_tpu_torch.models.proposals import generate_proposals
    from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align

    cfg = chip_smoke.flagship_config()
    det = build_detector(cfg, seed=chip_smoke.SEED, device=device)
    chip_smoke.settle_random_weights(det.model)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        chip_smoke.write_mosaic(path)
        tiles = chip_smoke.read_tiles(path, 2048, 512)[: cfg.batch_size]
    model, h, c = det.model, cfg.image_shape[0], cfg.image_shape[2]
    anchors, metas = det._constants(cfg.image_shape)
    rpn_std, bbox_std, mean = det._consts_of[0]
    cuda = clock.cuda
    rows = []

    det.fetch(det.dispatch_tiles(tiles))  # warm-up
    enqueue, fetched = [], None
    for _ in range(reps):
        t = time.perf_counter()
        handle = det.dispatch_tiles(tiles)
        enqueue.append(1e3 * (time.perf_counter() - t))
        fetched = det.fetch(handle)
    rows.append(stage_row("host enqueue", statistics.median(enqueue), clock="host"))

    host = torch.from_numpy(np.ascontiguousarray(tiles))
    host = host.pin_memory() if cuda else host
    with torch.inference_mode():
        def h2d():
            return host.to(device, non_blocking=cuda)

        def premold(x):
            return x.float()[..., None].expand(-1, -1, -1, c) - mean

        def features(x):
            return model.features(x)

        def rpn(pyr):
            return model.rpn(pyr)

        def proposals(r):
            return generate_proposals(r[1], r[2], anchors, rpn_std, proposal_count=cfg.post_nms_rois_inference,
                                      nms_threshold=cfg.rpn_nms_threshold, pre_nms_limit=cfg.pre_nms_limit)[0]

        ms, u8 = clock.time(h2d, reps)
        rows.append(stage_row("H2D (u8 tiles)", ms, *clock.kernels(h2d, 5)))
        ms, molded = clock.time(lambda: premold(u8), reps)
        rows.append(stage_row("premold", ms, *clock.kernels(lambda: premold(u8), 5)))
        ms, pyramid = clock.time(lambda: features(molded), reps)
        rows.append(stage_row("backbone + FPN", ms, *clock.kernels(lambda: features(molded), 3)))
        ms, rpn_out = clock.time(lambda: rpn(pyramid), reps)
        rows.append(stage_row("RPN", ms, *clock.kernels(lambda: rpn(pyramid), 5)))
        ms, props = clock.time(lambda: proposals(rpn_out), reps)
        rows.append(stage_row("proposals + NMS", ms, *clock.kernels(lambda: proposals(rpn_out), 5),
                              bound=nms_bound(P, lambda: proposals(rpn_out))))
        levels = nhwc_levels(pyramid)
        level_shapes = [tuple(f.shape[1:3]) for f in levels]

        def align(boxes, pool):
            return roi_align(levels, boxes, (h, h), pool)

        ms, pooled = clock.time(lambda: align(props, cfg.pool_size), reps)
        rows.append(stage_row("ROIAlign pool 7", ms, *clock.kernels(lambda: align(props, cfg.pool_size), 5),
                              bound=kb.roi_align_bound(props, level_shapes, (h, h), cfg.pool_size,
                                                       levels[0].shape[-1], levels[0].element_size())))
        ms, heads = clock.time(lambda: model.classifier(pooled), reps)
        rows.append(stage_row("classifier head", ms, *clock.kernels(lambda: model.classifier(pooled), 5)))
        hm, wm = metas[:, 4:5], metas[:, 5:6]
        windows = (metas[:, 7:11] - torch.cat([torch.zeros_like(hm)] * 2 + [torch.ones_like(hm)] * 2, 1)) / \
            torch.cat([hm - 1, wm - 1, hm - 1, wm - 1], 1)

        def refine():
            return refine_detections(props, heads[1], heads[2], windows, bbox_std, num_classes=cfg.num_classes,
                                     max_instances=cfg.detection_max_instances,
                                     min_confidence=cfg.detection_min_confidence,
                                     nms_threshold=cfg.detection_nms_threshold)

        ms, dets = clock.time(refine, reps)
        rows.append(stage_row("refinement (per-class NMS)", ms, *clock.kernels(refine, 5),
                              bound=nms_bound(D, refine)))
        boxes = dets[..., :4].contiguous()
        ms, mpooled = clock.time(lambda: align(boxes, cfg.mask_pool_size), reps)
        rows.append(stage_row("ROIAlign pool 14", ms, *clock.kernels(lambda: align(boxes, cfg.mask_pool_size), 5),
                              bound=kb.roi_align_bound(boxes, level_shapes, (h, h), cfg.mask_pool_size,
                                                       levels[0].shape[-1], levels[0].element_size())))

        def mask_head():
            m = model.mask(mpooled)
            cls = dets[..., 4].long()[:, :, None, None, None].expand(-1, -1, *m.shape[2:4], 1)
            return torch.round(torch.gather(m, 4, cls)[..., 0] * 255.0).to(torch.uint8)

        ms, _ = clock.time(mask_head, reps)
        rows.append(stage_row("mask head + u8 wire", ms, *clock.kernels(mask_head, 5)))
    unmold = []
    for _ in range(max(3, reps // 4)):
        t = time.perf_counter()
        det.unmold_fetched(fetched)
        unmold.append(1e3 * (time.perf_counter() - t))
    rows.append(stage_row("unmold (host)", statistics.median(unmold), clock="host"))
    show("profile: detect step, serving flagship (ResNet-101 512^2 batch 8 bf16, 6000/1000/100)", rows, card)
    return rows


def profile_train(device, reps: int, clock: Clock, card: str) -> List[Dict]:
    import torch

    import chip_smoke
    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.train import trainer as T

    cfg = chip_smoke.train_config()
    with tempfile.TemporaryDirectory() as tmp:
        ds = chip_smoke.load_train_dataset(chip_smoke.write_train_dataset(tmp))
        pipe = TrainingPipeline(ds, cfg, seed=chip_smoke.SEED, augmentation=True, cache_bytes=1 << 30)
        batches = pipe.batches()
        host_ms, host_batches = [], []
        for _ in range(reps + 2):
            t = time.perf_counter()
            host_batches.append(next(batches))
            host_ms.append(1e3 * (time.perf_counter() - t))
    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(chip_smoke.SEED))
    chip_smoke.settle_random_weights(model)
    model.to(device)
    opt = T.make_optimizer(cfg, model, "all")
    anchors, rpn_std, cw = T._step_constants(model, pipe.anchors_normalized(), None)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    rows = [stage_row("host batch (pipeline)", statistics.median(host_ms[2:]), clock="host")]
    it = iter(host_batches * 4)

    ms, b = clock.time(lambda: T.batch_to_device(next(it), device), reps)
    rows.append(stage_row("batch_to_device", ms, *clock.kernels(lambda: T.batch_to_device(next(it), device), 5)))
    ms, molded = clock.time(lambda: T.mold_batch(b, cfg, anchors.shape[0]), reps)
    rows.append(stage_row("mold_batch", ms, *clock.kernels(lambda: T.mold_batch(b, cfg, anchors.shape[0]), 5)))

    def forward():
        opt.zero_grad()
        return T._forward_losses(model, molded, anchors, rpn_std, cw, None, gen)[0]

    ms, losses = clock.time(forward, reps)
    rows.append(stage_row("forward + losses", ms, *clock.kernels(forward, 3)))
    ms, _ = clock.time(lambda ls: ls["total_loss"].backward(), reps, setup=forward)
    rows.append(stage_row("backward", ms, *clock.kernels(lambda ls: ls["total_loss"].backward(), 3, setup=forward)))
    ms, _ = clock.time(opt.step, reps)
    rows.append(stage_row("optimizer (Adam)", ms, *clock.kernels(opt.step, 5)))
    show("profile: train step, training flagship (ResNet-101 256^2 batch 8 bf16 Adam, 2000 proposals, 512 ROIs, "
         "300 GT)", rows, card)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default); cpu rehearses the control flow only")
    p.add_argument("--out", default=os.path.join(REPO, "build", "profile_stages.json"))
    args = p.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("profile_stages_torch: no CUDA device (pass --device cpu to rehearse on the CPU)")
    from caesar_mrcnn_tpu_torch import kernel_bench

    card = kernel_bench.card() if args.device != "cpu" else "cpu rehearsal, host clocks: not device measurements"
    if args.device != "cpu":
        from caesar_mrcnn_tpu_torch.ops import _kernels

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        _kernels.load(_kernels.build()[0])
    clock = Clock(args.device)
    out = {"card": card}
    out["detect"] = profile_detect(args.device, args.reps, clock, card)
    out["train"] = profile_train(args.device, args.reps, clock, card)
    if not clock.cuda:  # the host clock measured every stage
        for rows in (out["detect"], out["train"]):
            for r in rows:
                r["clock"] = "host"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"profile: written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
