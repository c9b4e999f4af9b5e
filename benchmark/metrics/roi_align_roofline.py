"""The ROIAlign forward kernel's share of its roofline in the traced
segment: the least time its work needs (``benchmark/bounds.py``'s
``roi_align_bound`` on the boxes of the segment's own calls) over the
profiler's time of its kernels (``roi_align_kernel``)."""

from benchmark.bounds import roi_align_bound


def _is_forward(name: str) -> bool:
    return "roi_align_kernel" in name and "backward" not in name


def read(record):
    trace = record.get("trace")
    calls = record.get("roi_calls")
    if trace is None or not calls:
        return None
    seconds = trace.kernel_seconds(_is_forward)
    if seconds <= 0:
        return None
    bound_ms = sum(roi_align_bound(c["boxes"], c["levels"], c["image"], c["pool"], c["c"], c["itemsize"])[0]
                   for c in calls)
    return 100.0 * bound_ms * 1e-3 / seconds
