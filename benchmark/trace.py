"""Device trace of a traced segment: ``torch.profiler`` (CPU and CUDA
activity) around the benchmark's own calls, reduced to what the per-layer
readers and the result's ``breakdown`` need.

The reduction reads the profiler's Chrome trace: device intervals are the
events of the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the
traced window runs from the start of the first of the benchmark's spans
(``record_function``, category ``user_annotation``) to the end of the
last; ``busy_s`` is the length of the union of the device intervals
inside it; each idle gap between them is named by the benchmark span that
the host was in when the gap began.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start s, seconds)
    device_ops: List[List] = field(default_factory=list)  # [[name, seconds]] by total time
    idle_gaps: List[List] = field(default_factory=list)   # [[span name, seconds]] longest first
    batches: int = 0  # units of work in the traced window, set by the driver

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose name ``match(name)`` accepts."""
        return sum(d for name, _, d in self.kernels if match(name))


def profiler():
    """A profiler of CPU and CUDA activity, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize(prof, spans: Tuple[str, ...], tmp_dir: str) -> TraceSummary:
    """Reduce a finished profiler run; ``spans`` are the names of the
    benchmark's ``record_function`` spans."""
    path = os.path.join(tmp_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events, spans)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_events(events: List[Dict], spans: Tuple[str, ...]) -> TraceSummary:
    """The reduction of :func:`summarize` on Chrome trace events (times in us)."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") in spans)
    if not host:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    t0, t1 = host[0][0], max(e for _, e, _ in host)
    device = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            s = float(e["ts"])
            d = float(e.get("dur", 0.0))
            if s + d > t0 and s < t1:
                device.append((e["name"], max(s, t0), min(s + d, t1)))
    busy = _union([(s, e) for _, s, e in device])
    by_name: Dict[str, float] = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = []
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((_span_at(host, s), (e - s) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        kernels=[(name, s * 1e-6, (e - s) * 1e-6) for name, s, e in device if not _is_copy(name)],
        device_ops=[[name[:120], sec * 1e-6] for name, sec in ops],
        idle_gaps=[[name, sec] for name, sec in gaps[:TOP]],
    )


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _span_at(host: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost benchmark span that holds time ``t``, or ``other``."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "other"
