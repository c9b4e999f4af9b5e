"""Tiled detect through the port's int8 serving graph: the closed loop of
:mod:`.detect_tiles` (``Detector.dispatch_tiles`` / ``fetch`` /
``unmold_fetched``, a fixed number of batches in flight) on a
configuration with ``quant_mode="int8"``, and what the int8 graph adds:

* the detector calibrates on its first batch by itself; that batch runs
  alone under ``telemetry.recording()``, so that the calibration's spans
  and counters land in the record, before the warm-up passes (the port's
  CUDA kernels are built before it: the span holds the calibration, not
  ``nvcc``). Its tiles are kept, for the reference to calibrate on;
* the window counts the int8 kernels' launches (the wrappers' counters);
* a traced run records the shapes of the int8 convolution's and the
  quantizer's calls in the profiled segment, for their rooflines
  (``benchmark/int8_bounds.py``), beside ROIAlign's;
* for the judged batches, the window keeps the pyramid that the int8
  graph's features stage made, beside the step's output: a copy to host
  memory queued on the step's own stream, so that the device holds no
  more than it would (the warm-up passes keep one batch's, so that the
  pinned host memory is allocated before the window);
* the judge is ``reference/judge_detect_int8.py``: the program's scales,
  the window's outputs and pyramids, against the reference calibrated on
  the same tiles by itself.
"""

from __future__ import annotations

import gc
import os
import tempfile
from typing import Callable, Dict, List

import numpy as np

from .. import inputs, trace
from ..flops import detect_flops_per_image
from ..int8_bounds import conv_call, quantize_call
from ..reference import judge_detect, judge_detect_int8
from ..weights import make_weights
from .detect_tiles import SPANS, Capture, RoiCalls, build_detector, closed_loop, patched


class StepAndPyramid(Capture):
    """:class:`.detect_tiles.Capture` of the step that keeps ``(output,
    pyramid)``: :meth:`features`, put in place of the int8 graph's
    ``DetectStages.features``, copies the pyramid to the host (queued on
    the current stream, pinned, not waited on) while ``keep`` is set."""

    def __init__(self, fn, features):
        super().__init__(fn)
        self.features_fn = features
        self.pyramid = None

    def features(self, stages, images):
        out = self.features_fn(stages, images)
        if self.keep:
            self.pyramid = [p.to("cpu", non_blocking=True) for p in out]
        return out

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.keep:
            self.kept, self.pyramid = (out, self.pyramid), None
        return out


class Calls:
    """A wrapper of a kernel's call site that records ``describe(*args)``
    of each call."""

    def __init__(self, fn, describe: Callable[..., Dict]):
        self.fn, self.describe = fn, describe
        self.calls: List[Dict] = []

    def __call__(self, *args, **kwargs):
        self.calls.append(self.describe(*args, **kwargs))
        return self.fn(*args, **kwargs)


def _launches(quant) -> Dict[str, int]:
    out = {"conv2d_int8": quant.conv2d_int8.launches, "quantize_int8": quant.quantize_int8.launches}
    out.update({f"conv2d_int8.{k}": v for k, v in quant.conv2d_int8.route_launches.items()})
    return out


def run(ctx) -> Dict:
    """One run of the int8 tiled detect cell (see the module's docstring)."""
    import caesar_mrcnn_tpu_torch.inference.detector as detector_module
    import caesar_mrcnn_tpu_torch.models.backbone_int8 as backbone_int8
    import caesar_mrcnn_tpu_torch.models.heads_int8 as heads_int8
    import caesar_mrcnn_tpu_torch.models.mask_rcnn as mask_rcnn_module
    from caesar_mrcnn_tpu_torch import telemetry
    from caesar_mrcnn_tpu_torch.ops import quant

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
    capture = StepAndPyramid(detector_module.forward_inference, heads_int8.DetectStages.features)
    rng = np.random.default_rng(int(ctx.seed))
    lo, hi = traffic["check_from"], traffic["check_before"]
    judged = set(int(v) for v in rng.choice(np.arange(lo, hi), size=traffic["check_batches"], replace=False))

    if ctx.cuda:  # the port's kernels built, or loaded from the checkout's build, before the calibrating batch
        from caesar_mrcnn_tpu_torch.ops import _kernels

        _kernels.library()
    with patched(detector_module, "forward_inference", capture), \
            patched(heads_int8.DetectStages, "features", lambda stages, images: capture.features(stages, images)):
        with telemetry.recording() as rec:
            closed_loop(det, batches[:1], 0.0, traffic["in_flight"], count=1)
        calibrated = rec.summary()
        ctx.log(f"first batch (calibrates): spans {calibrated['spans']}, counters {calibrated['counters']}")
        for _ in range(traffic["warmup_passes"]):
            closed_loop(det, batches, 0.0, traffic["in_flight"], count=len(batches), capture=capture, judged={0})
        ctx.sync()
        ctx.log(f"set-up done: weights, detector, calibration, {traffic['warmup_passes']} warm-up passes "
                f"[{ctx.elapsed():.2f} s since start]")

        ctx.reset_peak()
        setup_s = ctx.elapsed()
        before = _launches(quant)
        window = closed_loop(det, batches, ctx.seconds, traffic["in_flight"], capture=capture, judged=judged)
        peak = ctx.peak_bytes()
        ctx.log("launches a batch in the window: " + ", ".join(
            f"{k} {(v - before[k]) / max(window['batches'], 1):.2f}" for k, v in _launches(quant).items()))

        summary, roi, convs, quants = None, None, None, None
        if ctx.trace:
            roi = RoiCalls(mask_rcnn_module.roi_align)
            convs = Calls(backbone_int8.conv2d_int8, conv_call)
            quants = Calls(backbone_int8.quantize_int8, quantize_call)
            with patched(mask_rcnn_module, "roi_align", roi), patched(backbone_int8, "conv2d_int8", convs), \
                    patched(backbone_int8, "quantize_int8", quants), trace.profiler() as prof:
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
        "int8_conv_calls": convs.calls if convs else [], "int8_quantize_calls": quants.calls if quants else [],
        "int8_calibration": calibrated,
    }
    lat_ms = sorted(1e3 * x for x in window["latencies"])
    host_ms = {k: 1e3 * float(np.mean(v)) for k, v in window["spans"].items()}
    ctx.log(f"window: {window['tiles']} tiles ({window['detections'] / max(window['tiles'], 1):.2f} detections "
            f"each) in {window['batches']} batches over {window['seconds']:.3f} s; "
            f"{len(lat_ms)} batch latencies, median {np.median(lat_ms):.2f} ms; host ms a batch {host_ms}")
    metrics = {
        "detect_tiles_per_s": window["tiles"] / window["seconds"],
        "detect_batch_p95_ms": float(np.percentile(lat_ms, 95)),
        "device_peak_gib": peak / 2**30,
        "setup_s": setup_s,
    }

    # the judged batches' tiles and the program's scales; then its state freed before the reference runs
    ctx.sync()
    kept = window["kept"]
    program = {o: dict(kept[o], tiles=batches[o % len(batches)]) for o in sorted(kept)}
    failed += bs * len(judged - set(kept))  # judged batches never dispatched
    scales = {site: float(q["s_in"]) for site, q in (det.qtree or {}).items()}
    del det, capture
    gc.collect()
    ctx.empty_cache()
    batches_judged = []
    for p in program.values():
        if "results" not in p:
            failed += bs
            continue
        step, pyramid = p.pop("step")
        p.update(rpn_probs=step.rpn_probs, proposals=step.rpn_rois, pyramid=pyramid)
        batches_judged.append(p)
    if not scales or not batches_judged:
        compared, diagnostics, readings = {}, {}, []
    else:
        compared, diagnostics, readings = judge_detect_int8.judge(sd, model_cfg, batches[0], scales, batches_judged)
    if ctx.detail is not None:
        ctx.detail.update(judge_detect.distribution(readings), diagnostics=diagnostics)
    ctx.log(f"judged {len(readings)} batches of the window (ordinals {sorted(program)}) against the int8 "
            f"reference; {len(scales)} sites; diagnostics, not compared: {diagnostics}")
    return {"attempted": attempted, "failed": failed, "metrics": metrics, "peak_bytes": peak,
            "record": record, "compared": compared}
