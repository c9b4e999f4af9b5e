"""Host ms a batch in the port's ``detect.step`` spans (the host enqueue of
the detect graph and its output staging), over the telemetry segment's
batches.
``benchmark/program_trace.py`` makes the record's ``program``."""

from benchmark.program_trace import host_span_ms


def read(record):
    return host_span_ms(record, "detect.step")
