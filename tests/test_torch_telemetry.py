"""The port's spans and counters (``caesar_mrcnn_tpu_torch/telemetry.py``)
on the CPU, at a small detector (custom backbone, 64^2 tiles, batch 2,
f32, 128 / 32 proposals, 8 detections, seed 0 weights), and the
benchmark's reduction of them (``benchmark/program_trace.py`` and its
seven readers) on hand-made records and trace events.

* off: no span is made (the one shared no-op), nothing is recorded, and
  the detect step's outputs and the unmolded results are bit for bit the
  same with recording on;
* on: the detect path's spans with their parents and one batch id per
  batch, the unmold's counters (the tiled path's pasted detections, the
  host paste's two timed halves in ``detect``), self times, spans
  on another thread, the wrappers' launch counts, the tiled catalog's
  spans through ``detect --telemetry``, the int8 graph's calibration
  spans once a calibration with its sites counted (none on the float
  path);
* under a CPU ``torch.profiler`` each span is a ``user_annotation`` event.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch import telemetry
from caesar_mrcnn_tpu_torch.cli import run as tcli
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.ops import nms, quant
from caesar_mrcnn_tpu_torch.utils import fits as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import program_trace as PT  # noqa: E402
from benchmark import run as R  # noqa: E402

torch.set_num_threads(2)

KW = dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
          class_names=("bkg", "sidelobe", "source", "galaxy"), rpn_anchor_scales=(8, 16, 32, 64, 128),
          pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=8, compute_dtype="float32")
DETECT = ("detect.stage_in", "detect.step", "detect.step.features", "detect.step.proposals", "detect.step.heads",
          "detect.fetch", "detect.unmold")


@pytest.fixture(scope="module")
def det():
    return build_detector(inference_config(detector_config(**KW), images_per_device=2, num_devices=1),
                          device="cpu", seed=0)


def _tiles(seed):
    return np.random.RandomState(seed).randint(0, 255, (2, 64, 64), np.uint8)


def test_off_makes_no_span_and_records_nothing(det):
    assert not telemetry.active()
    assert telemetry.span("detect.step", batch=3) is telemetry.span("x")
    telemetry.count("x", 5)
    det.collect(det.dispatch_tiles(_tiles(0)))  # spans and counters while off
    with telemetry.recording() as rec:
        pass
    assert not telemetry.active() and rec.spans == [] and rec.summary() == {"spans": {}, "counters": {},
                                                                             "batches": 0}


def test_outputs_bit_equal_on_and_off(det):
    """The step's outputs, and the unmolded results of the tiled path and
    of ``detect`` (whose host paste counts its two timed halves while
    recording), equal those with recording off."""
    anchors, metas = det._constants((64, 64, 3))
    molded = torch.from_numpy(_tiles(1).astype(np.float32))[..., None].expand(-1, -1, -1, 3) - det._mean
    images = list(np.repeat(_tiles(4)[..., None], 3, -1))
    off = det._step(molded, metas[:1].expand(2, -1), anchors)
    results_off = det.collect(det.dispatch_tiles(_tiles(1))) + det.detect(images)
    with telemetry.recording() as rec:
        on = det._step(molded, metas[:1].expand(2, -1), anchors)
        results_on = det.collect(det.dispatch_tiles(_tiles(1))) + det.detect(images)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert len(results_on) == 4 and all(len(r["scores"]) > 0 for r in results_on)
    for a, b in zip(results_off, results_on):
        for key in ("rois", "class_ids", "scores", "masks"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    counters = rec.summary()["counters"]
    assert counters["detect.unmold.resize_ns"] > 0
    assert counters["detect.unmold.device_pasted"] == sum(len(r["scores"]) for r in results_on[:2])


def test_detect_path_spans_parents_and_batch_ids(det):
    """Two batches in flight: each span of the table once a batch (the
    stage-in twice: the host half and the device half), the stages under
    ``detect.step``, every span of a batch with that batch's id, and the
    unmold's counter of the detections pasted into the tiles' frames (the
    host paste's two timed counters stay off this path)."""
    with telemetry.recording() as rec:
        h1, h2 = det.dispatch_tiles(_tiles(2)), det.dispatch_tiles(_tiles(3))
        assert h1[4] != h2[4] and len(h1[1]) == 0  # the batch id; the events list (none on the CPU)
        results = [r for h in (h1, h2) for r in det.unmold_fetched(det.fetch(h))]
    by_batch = {}
    for s in rec.spans:
        by_batch.setdefault(s.batch, []).append(s.name)
    assert set(by_batch) == {h1[4], h2[4]}
    for names in by_batch.values():
        assert sorted(names) == sorted(DETECT + ("detect.stage_in",))
    parents = {s.name: s.parent.name if s.parent else None for s in rec.spans}
    assert parents == {"detect.stage_in": None, "detect.step": None, "detect.fetch": None, "detect.unmold": None,
                       "detect.step.features": "detect.step", "detect.step.proposals": "detect.step",
                       "detect.step.heads": "detect.step"}
    summary = rec.summary()
    assert summary["batches"] == 2 and summary["spans"]["detect.step"]["calls"] == 2
    c = summary["counters"]
    assert c["detect.unmold.device_pasted"] == sum(len(r["scores"]) for r in results) > 0
    assert "detect.unmold.resize_ns" not in c and "detect.unmold.write_ns" not in c
    json.dumps(summary)


INT8 = ("detect.int8.calibrate", "detect.int8.calibrate.observe", "detect.int8.calibrate.quantize")


def test_int8_calibration_spans_once_and_counts_the_sites():
    """The int8 graph's calibration: ``detect.int8.calibrate`` and its two
    children once a calibration (the first batch calibrates, the next does
    not, a batch after the weights changed calibrates again), under the
    calibrating batch's ``detect.step``; ``detect.int8.sites`` counts the
    quantized tree's sites each time."""
    cfg = inference_config(detector_config(**KW, quant_mode="int8"), images_per_device=2, num_devices=1)
    det8 = build_detector(cfg, device="cpu", seed=0)
    with telemetry.recording() as rec:
        det8.collect(det8.dispatch_tiles(_tiles(5)))
        det8.collect(det8.dispatch_tiles(_tiles(6)))
    summary = rec.summary()
    assert {name: summary["spans"][name]["calls"] for name in INT8} == dict.fromkeys(INT8, 1)
    parents = {s.name: s.parent.name for s in rec.spans if s.name in INT8}
    assert parents == {"detect.int8.calibrate": "detect.step", "detect.int8.calibrate.observe": "detect.int8.calibrate",
                       "detect.int8.calibrate.quantize": "detect.int8.calibrate"}
    assert summary["counters"]["detect.int8.sites"] == len(det8.qtree) == 60
    observe = next(s for s in rec.spans if s.name == "detect.int8.calibrate.observe")
    folded_pass = [s.name for s in rec.spans if s.parent is observe]
    assert folded_pass == ["detect.step.features", "detect.step.proposals", "detect.step.heads"]
    with torch.no_grad():
        det8.model.fpn.fpn_p2.bias.add_(0.0)  # a write in place: the int8 graph is dropped
    with telemetry.recording() as rec:
        det8.collect(det8.dispatch_tiles(_tiles(7)))
    summary = rec.summary()
    assert {name: summary["spans"][name]["calls"] for name in INT8} == dict.fromkeys(INT8, 1)
    assert summary["counters"]["detect.int8.sites"] == 60


def test_the_float_path_records_no_calibration(det):
    with telemetry.recording() as rec:
        det.collect(det.dispatch_tiles(_tiles(8)))
    summary = rec.summary()
    assert not set(INT8) & set(summary["spans"]) and "detect.int8.sites" not in summary["counters"]
    assert "detect.step" in summary["spans"]


def test_self_time_threads_and_nesting():
    """Self time is a span's duration less its children's; a span on
    another thread nests on that thread's own stack; recordings do not
    nest."""
    def work():
        with telemetry.span("catalog.read"):
            time.sleep(0.002)

    with telemetry.recording() as rec:
        with telemetry.span("outer", batch=7):
            with telemetry.span("inner"):
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=10)
                time.sleep(0.002)
            time.sleep(0.002)
        with pytest.raises(RuntimeError):
            with telemetry.recording():
                pass
    assert not t.is_alive()
    spans = {s.name: s for s in rec.spans}
    assert spans["inner"].parent is spans["outer"] and spans["catalog.read"].parent is None
    assert spans["inner"].batch == 7  # a child takes its parent's batch id
    rows = rec.summary()["spans"]
    assert rows["outer"]["self_ms"] == pytest.approx(rows["outer"]["total_ms"] - rows["inner"]["total_ms"])
    assert rows["inner"]["self_ms"] == rows["inner"]["total_ms"] >= 2.0


def test_summary_carries_the_launch_counters():
    with telemetry.recording() as rec:
        nms.nms_padded.launches += 3
        quant.conv2d_int8.launches += 2
    nms.nms_padded.launches -= 3
    quant.conv2d_int8.launches -= 2
    counters = rec.summary()["counters"]
    assert counters == {"launches.nms_padded": 3, "launches.conv2d_int8": 2}


def test_spans_are_profiler_annotations(tmp_path):
    """Under a CPU profiler the spans are ``user_annotation`` events of the
    Chrome trace, on the thread that ran them, around the ops they hold."""
    from torch.profiler import ProfilerActivity, profile

    with telemetry.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("detect.step"):
            with telemetry.span("detect.step.features"):
                torch.ones(4) + 1
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert set(spans) == {"detect.step", "detect.step.features"}
    outer, inner = spans["detect.step"], spans["detect.step.features"]
    assert outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    add = next(e for e in events if e.get("name") == "aten::add")
    assert inner["ts"] <= add["ts"] <= inner["ts"] + inner["dur"]


def test_detect_cli_writes_the_catalog_spans(tmp_path, monkeypatch):
    """``detect --split_img_in_tiles --telemetry FILE`` on a 256^2 mosaic
    of 128^2 tiles: the catalog's spans, ``catalog.read`` once a chunk, and
    the detect path's under them."""
    rng = np.random.RandomState(0)
    data = rng.normal(0.0, 0.01, (256, 256)).astype(np.float32)
    data[20:40, 20:40] += 10.0
    F.write_fits(data, str(tmp_path / "mosaic.fits"),
                 header={"CDELT1": -2.8e-4, "CDELT2": 2.8e-4, "BMAJ": 1.5e-3, "BMIN": 1.2e-3})
    monkeypatch.chdir(tmp_path)
    argv = ["detect", "--image", "mosaic.fits", "--split_img_in_tiles", "--tile_xsize", "128", "--tile_ysize",
            "128", "--backbone", "custom", "--imgsize", "128", "--pre_nms_limit", "64", "--post_nms_rois_inference",
            "16", "--detection_max_instances", "4", "--nimg_per_gpu", "2", "--device", "cpu",
            "--telemetry", "telemetry.json", "--detect_outfile_json", "catalog.json", "--logs", str(tmp_path)]
    assert tcli.main(argv) == 0
    summary = json.loads((tmp_path / "telemetry.json").read_text())
    spans = summary["spans"]
    assert spans["catalog.read"]["calls"] == 2 and spans["catalog.sources"]["calls"] == 2
    assert {"catalog.wait", "catalog.gather", "catalog.merge", "catalog.save"} <= set(spans)
    assert set(DETECT) <= set(spans) and summary["batches"] == 2


# --------------------------------------------- the benchmark's reduction

def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    # host (us): detect.step [0, 100] holding features [10, 40] and heads [50, 90]; detect.unmold [100, 300]
    _x("user_annotation", "detect.step", 0, 100), _x("user_annotation", "detect.step.features", 10, 30),
    _x("user_annotation", "detect.step.heads", 50, 40), _x("user_annotation", "detect.unmold", 100, 200),
    _x("user_annotation", "unmold", 95, 210),  # a benchmark span, not the program's
    _x("cuda_runtime", "cudaLaunchKernel", 15, 2, corr=1), _x("cuda_driver", "cuLaunchKernel", 60, 2, corr=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 92, 2, corr=3), _x("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=4),
    # device: conv under features 20-60, align under heads 60-80, D2H copy under step 95-110, a kernel launched
    # between the stages (under detect.step), one with no launch 200-210; idle 0-20, 80-95, 110-200, 210-300
    _x("kernel", "conv", 20, 40, tid=7, corr=1), _x("kernel", "roi_align_kernel", 60, 20, tid=7, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH", 95, 15, tid=7, corr=3), _x("kernel", "add", 200, 10, tid=7, corr=99),
    _x("gpu_memset", "Memset", 80, 0, tid=7, corr=4),
]


def test_program_trace_reduces_hand_made_events():
    names = {"detect.step", "detect.step.features", "detect.step.heads", "detect.unmold"}
    out = PT.reduce_events(EVENTS, names)
    assert out["window_s"] == pytest.approx(300e-6) and out["busy_s"] == pytest.approx(85e-6)
    assert out["device_s"] == pytest.approx({"detect.step.features": 40e-6, "detect.step.heads": 20e-6,
                                             "detect.step": 15e-6})
    assert out["unattributed_s"] == pytest.approx(10e-6)
    assert out["device_ops"]["detect.step"] == [["Memcpy DtoH", pytest.approx(15e-6), 1], ["Memset", 0.0, 1]]
    assert [g[0] for g in out["idle_gaps"]] == ["detect.unmold", "detect.unmold", "detect.step", "detect.step.heads"]
    assert [g[1] for g in out["idle_gaps"]] == pytest.approx([90e-6, 90e-6, 20e-6, 15e-6])
    assert out["idle_s"] == pytest.approx({"detect.unmold": 180e-6, "detect.step": 20e-6, "detect.step.heads": 15e-6})
    with pytest.raises(RuntimeError):
        PT.reduce_events(EVENTS, {"catalog.read"})


RECORD = {"program": {
    "telemetry": {"summary": {"spans": {"detect.stage_in": {"calls": 8, "total_ms": 6.0, "self_ms": 6.0},
                                        "detect.step": {"calls": 4, "total_ms": 100.0, "self_ms": 10.0}},
                              "counters": {"detect.unmold.resize_ns": 80_000_000, "detect.unmold.write_ns": 40_000_000},
                              "batches": 4},
                  "tiles": 32, "batches": 4, "seconds": 1.0, "dispatch_ms": 110.0, "unmold_ms": 200.0},
    "device": {"device_s": {"detect.step.features": 0.02, "detect.step.proposals": 0.004,
                            "detect.step.heads": 0.008}, "batches": 2, "busy_s": 0.033, "window_s": 0.5,
               "unattributed_s": 0.001, "idle_s": {}, "idle_gaps": []}}}
EXPECTED = {"detect.stage_in_ms": 1.5, "detect.step_enqueue_ms": 25.0, "detect.unmold_resize_ms": 20.0,
            "detect.unmold_write_ms": 10.0, "detect.features_device_ms": 10.0, "detect.proposals_device_ms": 2.0,
            "detect.heads_device_ms": 4.0}


@pytest.mark.parametrize("name", PT.READERS)
def test_program_readers(name):
    read = R._metric_reader(name)
    assert read({"spans": {}, "trace": None}) is None
    assert read(RECORD) == pytest.approx(EXPECTED[name])
    assert all(line for line in PT.describe(RECORD["program"]))
