"""Device ms per batch: the union of the device intervals (kernels,
copies, sets) in the traced segment over its batches."""


def read(record):
    trace = record.get("trace")
    if trace is None or not trace.batches or trace.busy_s <= 0:
        return None
    return 1e3 * trace.busy_s / trace.batches
