"""Host seconds of the int8 graph's calibration (the folded f32 pass that
observes every site, and the quantized tree built): the port's
``detect.int8.calibrate`` span, recorded over the cell's first batch."""


def read(record):
    spans = (record.get("int8_calibration") or {}).get("spans", {})
    row = spans.get("detect.int8.calibrate")
    return row["total_ms"] * 1e-3 if row else None
