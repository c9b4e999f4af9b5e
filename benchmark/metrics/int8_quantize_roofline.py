"""The int8 quantizer kernels' share of their roofline in the traced
segment: the least time their work needs (``benchmark/int8_bounds.py``'s
``quantize_bound`` on the sizes of the segment's own ``quantize_int8``
calls) over the profiler's time of the kernels (``quantize_int8``, the
stem's padding one too)."""

from benchmark.int8_bounds import quantize_bound


def _is_quantizer(name: str) -> bool:
    return "quantize_int8" in name


def read(record):
    trace = record.get("trace")
    calls = record.get("int8_quantize_calls")
    if trace is None or not calls:
        return None
    seconds = trace.kernel_seconds(_is_quantizer)
    if seconds <= 0:
        return None
    return 100.0 * sum(quantize_bound(c) for c in calls) * 1e-3 / seconds
