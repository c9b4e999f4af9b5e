"""Host ms a batch in the port's ``detect.stage_in`` spans (tail padding,
pinning, the H2D copy and premold), over the telemetry segment's batches.
``benchmark/program_trace.py`` makes the record's ``program``."""

from benchmark.program_trace import host_span_ms


def read(record):
    return host_span_ms(record, "detect.stage_in")
