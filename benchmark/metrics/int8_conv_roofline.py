"""The int8 convolution kernels' share of their roofline in the traced
segment: the least time their work needs (``benchmark/int8_bounds.py``'s
``conv_int8_bound`` on the shapes of the segment's own ``conv2d_int8``
calls) over the profiler's time of the kernels (``conv_int8``: both
routes)."""

from benchmark.int8_bounds import conv_int8_bound


def _is_conv(name: str) -> bool:
    return "conv_int8" in name


def read(record):
    trace = record.get("trace")
    calls = record.get("int8_conv_calls")
    if trace is None or not calls:
        return None
    seconds = trace.kernel_seconds(_is_conv)
    if seconds <= 0:
        return None
    return 100.0 * sum(conv_int8_bound(c) for c in calls) * 1e-3 / seconds
