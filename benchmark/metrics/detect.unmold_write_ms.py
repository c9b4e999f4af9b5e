"""Host ms a batch in the unmold's threshold and write of each resized mask
into its tile's fresh frame, where the frame's page faults land (the
port's counter ``detect.unmold.write_ns``), over the telemetry segment's
batches.
``benchmark/program_trace.py`` makes the record's ``program``."""

from benchmark.program_trace import counter_ms


def read(record):
    return counter_ms(record, "detect.unmold.write_ns")
