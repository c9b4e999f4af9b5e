"""Host ms a batch in the unmold's bilinear resize of each detection's mask
to its box (the port's counter ``detect.unmold.resize_ns``), over the
telemetry segment's batches.
``benchmark/program_trace.py`` makes the record's ``program``."""

from benchmark.program_trace import counter_ms


def read(record):
    return counter_ms(record, "detect.unmold.resize_ns")
