"""Device ms a batch of the kernels, copies and sets launched under the
port's ``detect.step.heads`` span (both ROIAligns, classifier,
refinement, mask head, the u8 wire), over the profiled segment's
batches.
``benchmark/program_trace.py`` makes the record's ``program``."""

from benchmark.program_trace import device_ms


def read(record):
    return device_ms(record, "detect.step.heads")
