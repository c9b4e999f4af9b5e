"""Spans and counters of the port: its one tracing system.

Recording is off unless a caller opens :func:`recording`, which switches
it on for the process and yields the :class:`Recorder` that keeps what is
recorded, in memory, until :meth:`Recorder.summary` exports it. Leaving
the context switches recording off again.

* :func:`span` times a block: ``with span("detect.step", batch=b): ...``.
  Off, it returns one shared no-op context manager (a module-global read,
  no allocation, no torch call). On, it records the span's name, start and
  end (``time.perf_counter_ns``), the span it ran inside on the same
  thread (its parent) and the batch id (its parent's, unless given), and
  enters ``torch.profiler.record_function(name)``, so that under a
  profiler the span is a ``user_annotation`` event on the clock of the
  device's kernels.
* :func:`count` adds to a named counter; off, it returns at once.

The kernel wrappers' launch counters (``nms_padded.launches``,
``roi_align.launches``, ...) stay on the wrappers; the summary carries
what they counted during the recording.

The spans of the detect path (``inference/detector.py``,
``models/mask_rcnn.py::forward_inference``): ``detect.stage_in``,
``detect.step`` (its children ``detect.step.features``, ``.proposals``,
``.heads``; the masks' paste into the tiles' frames is launched in it,
after them), ``detect.fetch``, ``detect.unmold``; counters
``detect.unmold.resize_ns`` and ``detect.unmold.write_ns`` (the host
paste), and ``detect.unmold.device_pasted`` (the detections that
``caesar::paste_masks`` pasted on the tiled path: its kernel on a CUDA
device). Of the int8 graph's calibration (``Detector._quantize_molded``):
``detect.int8.calibrate`` and its children ``.observe`` and ``.quantize``,
and the counter ``detect.int8.sites``. Of the float graph's features
replayed as a CUDA graph (``inference/graphed.py``): the counters
``detect.features.graph_captures`` and ``detect.features.graph_replays``.
Of the tiled catalog (``analysis/sfinder.py::SFinder.run_tiled``):
``catalog.read`` (on the producer thread), ``catalog.wait``,
``catalog.sources``, ``catalog.gather``, ``catalog.merge``, ``catalog.save``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

from torch.profiler import record_function

_recorder: Optional["Recorder"] = None  # the open recording, if any
_local = threading.local()  # .stack: the thread's open spans, innermost last


class _Off:
    """The no-op span returned while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span (times in ``perf_counter_ns``)."""

    __slots__ = ("name", "batch", "parent", "start_ns", "end_ns", "_recorder", "_annotation")

    def __init__(self, recorder: "Recorder", name: str, batch):
        self.name, self.batch = name, batch
        self._recorder = recorder
        self.parent: Optional[Span] = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            if self.batch is None:
                self.batch = self.parent.batch
        stack.append(self)
        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._annotation.__exit__(*exc)
        self._annotation = None
        _stack().pop()
        self._recorder.spans.append(self)
        return False


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, batch=None):
    """A context manager that records a span named ``name`` while a
    recording is open, and does nothing otherwise."""
    rec = _recorder
    if rec is None:
        return _OFF
    return Span(rec, name, batch)


def active() -> bool:
    """Whether a recording is open."""
    return _recorder is not None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a recording is open."""
    rec = _recorder
    if rec is not None:
        rec.add(name, n)


def _launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters, now."""
    from .ops import nms, paste, quant, roi_align

    return {f"launches.{f.__name__}": f.launches for f in (
        nms.nms_padded, roi_align.roi_align, roi_align.roi_align_backward, roi_align.crop_and_resize,
        quant.quantize_int8, quant.conv2d_int8, paste.paste_masks)}


class Recorder:
    """The spans and counters of one recording, in memory."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._launches_at_start = _launches()
        self._launches_at_end: Optional[Dict[str, int]] = None

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> Dict:
        """Per span name its calls, total ms and self ms (its duration less
        the part its child spans cover); per counter its total, the launch
        counters' changes over the recording among them; and the number of
        distinct batch ids the spans carried. JSON-able."""
        spans = list(self.spans)
        child_ns: Dict[int, int] = {}
        for s in spans:
            if s.parent is not None:
                child_ns[id(s.parent)] = child_ns.get(id(s.parent), 0) + s.end_ns - s.start_ns
        by_name: Dict[str, Dict] = {}
        for s in spans:
            row = by_name.setdefault(s.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
            dur = s.end_ns - s.start_ns
            row["calls"] += 1
            row["total_ms"] += dur * 1e-6
            row["self_ms"] += (dur - child_ns.get(id(s), 0)) * 1e-6
        counters = dict(self.counters)
        end = self._launches_at_end or _launches()
        for name, n in end.items():
            if n != self._launches_at_start.get(name, 0):
                counters[name] = n - self._launches_at_start.get(name, 0)
        return {"spans": by_name, "counters": counters,
                "batches": len({s.batch for s in spans if s.batch is not None})}


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans and counters inside the block; yields the
    :class:`Recorder`. Recordings do not nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("telemetry.recording() is already open")
    rec = Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
        rec._launches_at_end = _launches()
