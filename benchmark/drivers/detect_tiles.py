"""Tiled detect: a closed loop of u8 tiles through the port's tiled
detector, ``Detector.dispatch_tiles`` / ``fetch`` / ``unmold_fetched``,
with a fixed number of batches in flight, as ``SFinder.run_tiled`` keeps
them.

Set-up writes a seeded FITS mosaic to the run's temporary directory, reads
and zscales it into u8 tiles with the port's tile reader, makes the
weights on the device and builds the detector, then warms up every shape
with two passes over the tiles. The window then dispatches batch after
batch, round the tiles, until its seconds are up, and collects every
batch it dispatched: the rate is the tiles unmolded over the whole
window, the latency of a batch the time from its ``dispatch_tiles`` call
to its unmolded results. A traced run then profiles a segment of more
batches of the same loop. Last, batches of the window drawn from the seed
are judged against the reference (``reference/judge_detect.py``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import inputs, trace
from ..flops import detect_flops_per_image
from ..reference import judge_detect
from ..weights import make_weights

SPANS = ("dispatch", "fetch_wait", "unmold")


class Capture:
    """A wrapper of the detector's step function that, while ``keep`` is
    set, keeps the step's output (its proposals and RPN probabilities stay
    on the device; nothing is copied or waited on)."""

    def __init__(self, fn):
        self.fn = fn
        self.keep = False
        self.kept = None

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.keep:
            self.kept = out
        return out


class RoiCalls:
    """A wrapper of the model's ROIAlign call site that records the boxes
    and shapes of each call (for the kernel's roofline)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls: List[Dict] = []

    def __call__(self, levels, boxes, image_shape, pool):
        self.calls.append({"boxes": boxes.detach().clone(), "levels": [tuple(f.shape[1:3]) for f in levels],
                           "image": tuple(int(v) for v in image_shape), "pool": int(pool),
                           "c": int(levels[0].shape[-1]), "itemsize": levels[0].element_size()})
        return self.fn(levels, boxes, image_shape, pool)


@contextlib.contextmanager
def patched(module, name: str, wrapper):
    saved = getattr(module, name)
    setattr(module, name, wrapper)
    try:
        yield wrapper
    finally:
        setattr(module, name, saved)


def build_detector(model_cfg: Dict, sd: Dict[str, torch.Tensor], device):
    """The port's ``Detector`` over a ``MaskRCNN`` of ``model_cfg`` holding
    ``sd``: the model is laid out on the meta device and materialised on
    ``device`` by ``load_state_dict``, so no weight is initialised twice."""
    from caesar_mrcnn_tpu_torch.config import detector_config
    from caesar_mrcnn_tpu_torch.inference.detector import Detector
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    cfg = detector_config(**{k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()})
    with torch.device("meta"):
        model = MaskRCNN(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    return Detector(cfg, model, device)


def closed_loop(det, batches: List[np.ndarray], seconds: float, depth: int, count: int = 0,
                capture: Capture = None, judged=(), traced: bool = False) -> Dict:
    """Dispatch batches round ``batches`` with ``depth`` in flight for
    ``seconds`` (or ``count`` batches) and collect each. Returns the
    tiles, batches and seconds of the loop, each batch's latency, each
    call's host seconds by span, and for the ordinals in ``judged`` the
    step's output that ``capture`` kept with the fetched and unmolded
    results."""
    from torch.profiler import record_function

    span = record_function if traced else (lambda name: contextlib.nullcontext())
    spans = {k: [] for k in SPANS}
    pending = collections.deque()
    kept: Dict[int, Dict] = {}
    latencies, done_at, tiles_done, detections, ordinal = [], [], 0, 0, 0
    start = time.perf_counter()
    stop = start + seconds

    def more() -> bool:
        return ordinal < count if count else time.perf_counter() < stop

    while True:
        if more():
            keep = ordinal in judged
            if keep:
                capture.keep = True
            t0 = time.perf_counter()
            with span("dispatch"):
                handle = det.dispatch_tiles(batches[ordinal % len(batches)])
            spans["dispatch"].append(time.perf_counter() - t0)
            if keep:
                kept[ordinal] = {"step": capture.kept}
                capture.keep, capture.kept = False, None
            pending.append((ordinal, t0, handle))
            ordinal += 1
            if len(pending) < depth:
                continue
        elif not pending:
            break
        o, t0, handle = pending.popleft()
        tw = time.perf_counter()
        with span("fetch_wait"):
            for event in handle[1]:
                event.synchronize()
        tf = time.perf_counter()
        with span("unmold"):
            fetched = det.fetch(handle)
            results = det.unmold_fetched(fetched)
        tu = time.perf_counter()
        spans["fetch_wait"].append(tf - tw)
        spans["unmold"].append(tu - tf)
        latencies.append(tu - t0)
        done_at.append(tu - start)
        tiles_done += len(results)
        detections += sum(len(r["class_ids"]) for r in results)
        if o in kept:
            kept[o].update(detections=fetched[0], masks=fetched[1], results=results)
    return {"tiles": tiles_done, "batches": ordinal, "detections": detections, "seconds": time.perf_counter() - start,
            "latencies": latencies, "done_at": done_at, "spans": spans, "kept": kept}


def run(ctx) -> Dict:
    """One run of a tiled detect cell (see the module's docstring)."""
    import caesar_mrcnn_tpu_torch.inference.detector as detector_module
    import caesar_mrcnn_tpu_torch.models.mask_rcnn as mask_rcnn_module

    model_cfg = ctx.config["config"]
    traffic = ctx.traffic
    side, size = traffic["mosaic_side"], model_cfg["image_max_dim"]
    with tempfile.TemporaryDirectory(dir=ctx.tmp_dir) as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        inputs.write_mosaic(path, n=side, seed=ctx.seed, sources=traffic["sources"])
        tiles = inputs.read_tiles(path, side, size)
    bs = model_cfg["images_per_device"]
    batches = [tiles[s:s + bs] for s in range(0, len(tiles), bs)]
    ctx.log(f"inputs: {len(tiles)} u8 tiles of {size}^2 from a seeded {side}^2 FITS mosaic, "
            f"{len(batches)} batches of {bs} [{ctx.elapsed():.2f} s since start]")

    sd = make_weights(model_cfg, ctx.seed, ctx.device)
    det = (ctx.make_detector or build_detector)(model_cfg, sd, ctx.device)
    capture = Capture(detector_module.forward_inference)
    rng = np.random.default_rng(int(ctx.seed))
    lo, hi = traffic["check_from"], traffic["check_before"]
    judged = set(int(v) for v in rng.choice(np.arange(lo, hi), size=traffic["check_batches"], replace=False))

    with patched(detector_module, "forward_inference", capture):
        for _ in range(traffic["warmup_passes"]):
            closed_loop(det, batches, 0.0, traffic["in_flight"], count=len(batches))
        ctx.sync()
        ctx.log(f"set-up done: weights, detector, {traffic['warmup_passes']} warm-up passes "
                f"[{ctx.elapsed():.2f} s since start]")

        ctx.reset_peak()
        setup_s = ctx.elapsed()
        window = closed_loop(det, batches, ctx.seconds, traffic["in_flight"], capture=capture, judged=judged)
        peak = ctx.peak_bytes()

        summary, roi = None, None
        if ctx.trace:
            roi = RoiCalls(mask_rcnn_module.roi_align)
            with patched(mask_rcnn_module, "roi_align", roi), trace.profiler() as prof:
                segment = closed_loop(det, batches, 0.0, traffic["in_flight"], traced=True,
                                      count=traffic["traced_batches"])
                ctx.sync()
            summary = trace.summarize(prof, SPANS, ctx.tmp_dir)
            summary.batches = segment["batches"]

    attempted = window["batches"] * bs
    failed = attempted - window["tiles"]
    record = {
        "window_s": window["seconds"], "tiles": window["tiles"], "batches": window["batches"],
        "spans": window["spans"], "trace": summary,
        "roi_calls": roi.calls if roi else [], "flops_per_tile": detect_flops_per_image(model_cfg),
    }
    lat_ms = sorted(1e3 * x for x in window["latencies"])
    host_ms = {k: 1e3 * float(np.mean(v)) for k, v in window["spans"].items()}
    ctx.log(f"window: {window['tiles']} tiles ({window['detections'] / max(window['tiles'], 1):.2f} detections "
            f"each) in {window['batches']} batches over {window['seconds']:.3f} s; "
            f"{len(lat_ms)} batch latencies, median {np.median(lat_ms):.2f} ms; host ms a batch {host_ms}")
    bins = np.bincount((np.asarray(window["done_at"]) // 5).astype(int))
    ctx.log(f"batches done in each 5 s of the window: {bins.tolist()}")
    metrics = {
        "detect_tiles_per_s": window["tiles"] / window["seconds"],
        "detect_batch_p95_ms": float(np.percentile(lat_ms, 95)),
        "device_peak_gib": peak / 2**30,
        "setup_s": setup_s,
    }

    # the judged batches' tiles, then the program's state freed before the reference runs
    kept = window["kept"]
    program = {o: dict(kept[o], tiles=batches[o % len(batches)]) for o in sorted(kept)}
    failed += bs * len(judged - set(kept))  # judged batches never dispatched
    del det, capture
    gc.collect()
    ctx.empty_cache()
    readings = []
    for o, p in program.items():
        if "results" not in p:
            failed += bs
            continue
        step = p.pop("step")
        p.update(rpn_probs=step.rpn_probs, proposals=step.rpn_rois)
        readings.append(judge_detect.judge_batch(sd, model_cfg, p.pop("tiles"), p))
    compared, diagnostics = judge_detect.merge(readings) if readings else ({}, {})
    if ctx.detail is not None:
        ctx.detail.update(judge_detect.distribution(readings), diagnostics=diagnostics)
    ctx.log(f"judged {len(readings)} batches of the window (ordinals {sorted(program)}); diagnostics, "
            f"not compared: {diagnostics}")
    return {"attempted": attempted, "failed": failed, "metrics": metrics, "peak_bytes": peak,
            "record": record, "compared": compared}
