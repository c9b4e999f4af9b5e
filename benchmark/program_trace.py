"""The program's own spans in the detect cell: the host split of the
enqueue and the unmold from a telemetry segment, and the device time of
each stage from a profiled one.

The port records spans and counters under
``caesar_mrcnn_tpu_torch.telemetry.recording()``; each span is also a
``torch.profiler`` ``user_annotation`` event. Two segments of the cell's
closed loop (``drivers/detect_tiles.py::closed_loop``) read them:

* :func:`telemetry_segment`: batches under ``recording()`` with no
  profiler (a profiler inflates every operator of the enqueue and every
  resize of the unmold), for the host metrics;
* a profiled segment under ``recording()``, reduced by
  :func:`reduce_profile`: the profiler's Chrome trace
  (:func:`export_events`, read by ``trace.reduce_events`` as well, since a
  profiler run saves its trace once) is reduced anew: each device event
  (kernel, memcpy, memset) is put down to the innermost program span that
  holds its host launch, the ``cuda_runtime`` or ``cuda_driver`` event
  with the same ``correlation`` (the port's ctypes-loaded kernels
  included). Device seconds are summed per span; each idle gap of the
  device is named by the innermost program span the host was in when it
  began.

What the two give is ``record["program"]``, which the readers
``metrics/detect.stage_in_ms.py``, ``detect.step_enqueue_ms``,
``detect.unmold_resize_ms``, ``detect.unmold_write_ms``,
``detect.features_device_ms``, ``detect.proposals_device_ms`` and
``detect.heads_device_ms`` read.

    python3 -m benchmark.program_trace --seed <n> [--seconds 20]

runs the detect cell's set-up, a window of ``--seconds`` with recording
off, then the two segments, logs what they read to standard error and
prints one JSON line: the window's tiles/s and host ms a batch, and
``program`` with the seven metrics. Without a CUDA device it exits with 2.
:func:`run` and :func:`main` copy the driver's set-up; they go once the
cell's driver runs the two segments itself, and only the reduction and
the readers stay.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
TOP = 10
TOP_OPS = 5
WORKLOAD = "detect.r101-512-bf16.tiles"
READERS = ("detect.stage_in_ms", "detect.step_enqueue_ms", "detect.unmold_resize_ms", "detect.unmold_write_ms",
           "detect.features_device_ms", "detect.proposals_device_ms", "detect.heads_device_ms")


def telemetry_segment(run_loop: Callable[[], Dict]) -> Dict:
    """``run_loop()`` (the cell's closed loop over a count of batches,
    returning ``closed_loop``'s dict) under ``telemetry.recording()``:
    the recording's summary, and the loop's own tiles, seconds and host
    ms in its ``dispatch`` and ``unmold`` calls."""
    from caesar_mrcnn_tpu_torch import telemetry

    with telemetry.recording() as rec:
        loop = run_loop()
    return {"summary": rec.summary(), "tiles": loop["tiles"], "batches": loop["batches"],
            "seconds": loop["seconds"], "dispatch_ms": 1e3 * sum(loop["spans"]["dispatch"]),
            "unmold_ms": 1e3 * sum(loop["spans"]["unmold"])}


def export_events(prof, tmp_dir: str) -> List[Dict]:
    """The Chrome trace events of a finished profiler run. A run saves its
    trace once, so these events also go to ``trace.reduce_events`` in place
    of ``trace.summarize``."""
    path = os.path.join(tmp_dir, "program_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def reduce_profile(events: List[Dict], summary: Dict) -> Dict:
    """:func:`reduce_events` over the program spans that ``summary`` (the
    profiled segment's ``Recorder.summary()``) names; ``batches`` is the
    recording's."""
    out = reduce_events(events, set(summary["spans"]))
    out["batches"] = summary["batches"]
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class _Spans:
    """Program spans (start, end, name), sorted by start, for the innermost
    one that holds a time."""

    def __init__(self, spans: Sequence[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float) -> Optional[str]:
        """The latest-starting span that holds ``t`` (spans of one thread
        nest, so that is the innermost), or None."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s, e, name = self.spans[i]
            if e >= t:
                return name
        return None


def reduce_events(events: List[Dict], names) -> Dict:
    """Device seconds by program span (and each span's largest device ops:
    name, seconds, events), unattributed device seconds, and idle gaps by
    program span, from Chrome trace events (times in us).
    ``names`` are the program's span names. The window runs from the start
    of the first program span to the end of the last."""
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"], e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in names]
    if not host:
        raise RuntimeError("the trace holds none of the program's spans")
    t0, t1 = min(s for s, _, _, _ in host), max(e for _, e, _, _ in host)
    threads: Dict = {}
    for s, e, name, tid in host:
        threads.setdefault(tid, []).append((s, e, name))
    by_thread = {tid: _Spans(v) for tid, v in threads.items()}
    anywhere = _Spans([(s, e, name) for s, e, name, _ in host])
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
    by_span: Dict[str, float] = {}
    ops: Dict[str, Dict[str, List[float]]] = {}  # span -> device op name -> [seconds, calls]
    unattributed, intervals = 0.0, []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = float(e["ts"])
        d = float(e.get("dur", 0.0))
        if s + d <= t0 or s >= t1:
            continue
        intervals.append((max(s, t0), min(s + d, t1)))
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = None
        if launch is not None and launch[1] in by_thread:
            name = by_thread[launch[1]].at(launch[0])
        if name is None:
            unattributed += d
            continue
        by_span[name] = by_span.get(name, 0.0) + d
        op = ops.setdefault(name, {}).setdefault(e["name"][:100], [0.0, 0])
        op[0] += d
        op[1] += 1
    busy = _union(intervals)
    gaps = []
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((anywhere.at(s) or "other", (e - s) * 1e-6))
    idle_by_span: Dict[str, float] = {}
    for name, sec in gaps:
        idle_by_span[name] = idle_by_span.get(name, 0.0) + sec
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "device_s": {k: v * 1e-6 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
            "device_ops": {k: [[op, sec * 1e-6, n] for op, (sec, n) in sorted(v.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]]
                           for k, v in ops.items()},
            "unattributed_s": unattributed * 1e-6, "idle_s": idle_by_span,
            "idle_gaps": [[name, sec] for name, sec in gaps[:TOP]]}


def host_span_ms(record: Dict, name: str) -> Optional[float]:
    """Host ms a batch in the spans ``name`` of the telemetry segment, or
    None where the record has none."""
    seg = (record.get("program") or {}).get("telemetry")
    if not seg or not seg["summary"]["batches"] or name not in seg["summary"]["spans"]:
        return None
    return seg["summary"]["spans"][name]["total_ms"] / seg["summary"]["batches"]


def counter_ms(record: Dict, name: str) -> Optional[float]:
    """ms a batch of the nanosecond counter ``name`` over the telemetry
    segment, or None where the record has none."""
    seg = (record.get("program") or {}).get("telemetry")
    if not seg or not seg["summary"]["batches"] or name not in seg["summary"]["counters"]:
        return None
    return seg["summary"]["counters"][name] * 1e-6 / seg["summary"]["batches"]


def device_ms(record: Dict, name: str) -> Optional[float]:
    """Device ms a batch of the events launched under the program span
    ``name`` in the profiled segment, or None where the record has none."""
    dev = (record.get("program") or {}).get("device")
    if not dev or not dev["batches"] or name not in dev["device_s"]:
        return None
    return 1e3 * dev["device_s"][name] / dev["batches"]


def describe(program: Dict) -> List[str]:
    """Lines for the log: the telemetry segment's host split, and the
    profiled segment's device ms by span, the unattributed share and the
    longest idle gaps."""
    lines = []
    seg = program.get("telemetry")
    if seg:
        n = max(seg["batches"], 1)
        spans = {k: round(v["total_ms"] / n, 3) for k, v in seg["summary"]["spans"].items()}
        counters = {k: round(v / n * 1e-6, 3) for k, v in seg["summary"]["counters"].items() if k.endswith("_ns")}
        lines.append(f"telemetry segment: {seg['batches']} batches, {seg['tiles'] / seg['seconds']:.2f} tiles/s; "
                     f"host ms a batch: loop dispatch {seg['dispatch_ms'] / n:.3f}, loop unmold "
                     f"{seg['unmold_ms'] / n:.3f}; spans {spans}; counters {counters}")
    dev = program.get("device")
    if dev:
        n = max(dev["batches"], 1)
        share = dev["unattributed_s"] / dev["busy_s"] if dev["busy_s"] > 0 else 0.0
        lines.append(f"device ms a batch by program span ({dev['batches']} batches): "
                     f"{ {k: round(1e3 * v / n, 3) for k, v in dev['device_s'].items()} }; unattributed "
                     f"{1e3 * dev['unattributed_s'] / n:.3f} ms a batch, {100 * share:.2f}% of busy_s "
                     f"{dev['busy_s']:.4f} s")
        for span_name, rows in dev.get("device_ops", {}).items():
            lines.append(f"largest device ops under {span_name} (ms a batch, events a batch): "
                         f"{[[op, round(1e3 * sec / n, 3), round(k / n, 1)] for op, sec, k in rows]}")
        lines.append(f"idle s by program span: { {k: round(v, 4) for k, v in dev['idle_s'].items()} }; "
                     f"longest gaps: {[[k, round(v, 4)] for k, v in dev['idle_gaps']]}")
    return lines


# ------------------------------------------------------- standalone run


def run(seed: int, seconds: float) -> Dict:
    """The detect cell's set-up and warm-up as its driver makes them, on
    the CUDA device, a window of ``seconds`` with recording off, then the
    telemetry segment (4 x ``traced_batches``) and the profiled segment
    (``traced_batches``)."""
    import numpy as np
    import torch

    from caesar_mrcnn_tpu_torch import telemetry

    from . import inputs, trace
    from . import run as R
    from .drivers.detect_tiles import SPANS, build_detector, closed_loop
    from .weights import make_weights

    manifest = R.load_json(os.path.join(R.ROOT, "BENCHMARK.json"))
    cell = R.find_cell(manifest, WORKLOAD)
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = R.load_json(os.path.join(R.ROOT, entry["file"]))
    traffic = R.load_json(os.path.join(R.ROOT, "benchmark", "traffic", f"{cell['traffic']}.json"))
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = R.Context(WORKLOAD, seed, seconds, True, config, traffic, dev, tmp)
        model_cfg = config["config"]
        side, size = traffic["mosaic_side"], model_cfg["image_max_dim"]
        path = os.path.join(tmp, "mosaic.fits")
        inputs.write_mosaic(path, n=side, seed=seed, sources=traffic["sources"])
        tiles = inputs.read_tiles(path, side, size)
        bs = model_cfg["images_per_device"]
        batches = [tiles[s:s + bs] for s in range(0, len(tiles), bs)]
        det = build_detector(model_cfg, make_weights(model_cfg, seed, dev), dev)
        depth = traffic["in_flight"]
        for _ in range(traffic["warmup_passes"]):
            closed_loop(det, batches, 0.0, depth, count=len(batches))
        ctx.sync()
        window = closed_loop(det, batches, seconds, depth)
        ctx.sync()
        program = {"telemetry": telemetry_segment(
            lambda: closed_loop(det, batches, 0.0, depth, count=4 * traffic["traced_batches"]))}
        ctx.sync()
        with telemetry.recording() as rec, trace.profiler() as prof:
            closed_loop(det, batches, 0.0, depth, traced=True, count=traffic["traced_batches"])
            ctx.sync()
        events = export_events(prof, tmp)
        summary = trace.reduce_events(events, SPANS)
        program["device"] = reduce_profile(events, rec.summary())
    record = {"program": program}
    metrics = {name: R._metric_reader(name)(record) for name in READERS}
    for line in describe(program):
        ctx.log(line)
    host_ms = {k: 1e3 * float(np.mean(v)) for k, v in window["spans"].items()}
    ctx.log(f"window (recording off): {window['tiles'] / window['seconds']:.2f} tiles/s over "
            f"{window['seconds']:.3f} s; host ms a batch {host_ms}; metrics {metrics}")
    return {"card": R.card(), "seed": seed,
            "window": {"tiles_per_s": window["tiles"] / window["seconds"], "batches": window["batches"],
                       "host_ms": host_ms},
            "busy_s": summary.busy_s, "window_s": summary.window_s, "metrics": metrics, "program": program}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("program_trace needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(json.dumps(run(args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
