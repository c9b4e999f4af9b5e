"""The detect step's share of the card's bf16 dense peak: the
configuration's FLOPs per tile (``benchmark/flops.py``) times the tiles of
the window, over the window's seconds, over 989 TFLOP/s."""

from benchmark.bounds import PEAK_BF16_PER_S


def read(record):
    if not record.get("tiles") or record.get("window_s", 0) <= 0:
        return None
    return 100.0 * record["flops_per_tile"] * record["tiles"] / record["window_s"] / PEAK_BF16_PER_S
