"""Faults planted in the int8 graph under the int8 detect cell's timed path,
and the cell's control, to show that its comparison
(``reference/judge_detect_int8.py``) finds them. Each is a context
manager that patches the port in this process only and yields a detector
factory (``run_cell``'s ``make_detector``); the files of the port are
never touched.

* ``per_tensor_weights``: every site's weights quantized at one scale per
  tensor (the largest channel's) instead of one per output channel;
* ``stage_scale_doubled``: the calibrated activation scale of every site of
  the ResNet's stage 4 (``bb/res4*``) doubled;
* ``residual_wrong_scale``: the residual stream that enters ``res3b``
  quantized for its first convolution at that block's second
  convolution's scale, while the epilogue assumes its own;
* ``rpn_score``: :mod:`.faults`' fault of that name, each anchor's
  objectness taken from the anchor before it where the proposals are made
  (``generate_proposals``, which the int8 graph shares with the float
  one): the RPN's objectness path, which ``proposal_score_short`` reads;
* the control, ``six_bit_weights``: a precision below the configuration's,
  through the same kernels: every site's weights rounded to 6 bits, every
  4th int8 level (``clip(round(w / (4 s_w)), -31, 31) * 4``).

Sound runs, the control and the faults, each seed in turn in one process:

    python -m benchmark.faults_int8 --seeds 11,12,13 --seconds 4 [--sides sound,six_bit_weights,...]

The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

from . import faults
from . import run as R
from .drivers import detect_tiles

CELL = "detect.r101-512-int8.tiles"
STAGE = "bb/res4"
RESIDUAL_SITE, WRONG_SITE = "bb/res3b/conv1", "bb/res3b/conv2"


@contextlib.contextmanager
def _quantize_conv(change):
    """Each site's int8 pack as ``change(w, b, s_in)`` makes it."""
    from caesar_mrcnn_tpu_torch.models import heads_int8

    with detect_tiles.patched(heads_int8, "quantize_conv", change):
        yield detect_tiles.build_detector


def _pack(wq: np.ndarray, sw: np.ndarray, b: np.ndarray, s_in) -> dict:
    s_in = np.float32(s_in)
    return {"w": wq.astype(np.int8), "sw": (sw * s_in).astype(np.float32), "b": np.asarray(b, np.float32),
            "s_in": s_in}


def per_tensor_weights():
    def per_tensor(w, b, s_in):
        wmax = np.full(w.shape[-1], max(float(np.abs(w).max()), 1e-12), np.float32)
        sw = (wmax / 127.0).astype(np.float32)
        return _pack(np.clip(np.round(w / sw), -127, 127), sw, b, s_in)

    return _quantize_conv(per_tensor)


def six_bit_weights():
    def six_bit(w, b, s_in):
        sw = (np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0).astype(np.float32)
        return _pack(np.clip(np.round(w / (4 * sw)), -31, 31) * 4, sw, b, s_in)

    return _quantize_conv(six_bit)


@contextlib.contextmanager
def stage_scale_doubled():
    from caesar_mrcnn_tpu_torch.models import heads_int8

    calibrate = heads_int8.calibrate_detect

    def doubled(*args, **kwargs):
        scales = calibrate(*args, **kwargs)
        return {site: 2.0 * s if site.startswith(STAGE) else s for site, s in scales.items()}

    with detect_tiles.patched(heads_int8, "calibrate_detect", doubled):
        yield detect_tiles.build_detector


@contextlib.contextmanager
def residual_wrong_scale():
    from caesar_mrcnn_tpu_torch.models.backbone_int8 import Int8Convs

    forward = Int8Convs.forward

    def wrong(self, site, x, *args, **kwargs):
        if site != RESIDUAL_SITE:
            return forward(self, site, x, *args, **kwargs)
        own = self.s_in[site]
        self.s_in[site] = self.s_in[WRONG_SITE]
        try:
            return forward(self, site, x, *args, **kwargs)
        finally:
            self.s_in[site] = own

    with detect_tiles.patched(Int8Convs, "forward", wrong):
        yield detect_tiles.build_detector


FAULTS = {"per_tensor_weights": per_tensor_weights, "stage_scale_doubled": stage_scale_doubled,
          "residual_wrong_scale": residual_wrong_scale, "rpn_score": faults.rpn_score}
CONTROL = {"six_bit_weights": six_bit_weights}


def planted(side: str):
    """The context manager of ``side``: ``sound``, a fault or the control."""
    if side == "sound":
        return contextlib.nullcontext(None)
    return {**FAULTS, **CONTROL}[side]()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--sides", default=",".join(["sound", *CONTROL, *FAULTS]),
                        help="comma-separated: sound, the control and the faults")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            detail = {}
            with planted(side) as factory:
                res = R.run_cell(CELL, seed, args.seconds, False, make_detector=factory, detail=detail)
            numbers = {k: v["value"] for k, v in res["compared"].items()}
            print(json.dumps({"side": side, "seed": seed, "correct": res["correct"], "compared": numbers,
                              "distribution": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
