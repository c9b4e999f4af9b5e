"""The control of a detect cell's comparison: the program with its own
lower-precision path switched on (``quant_mode="int8"``, the int8 graph
of the ``--serving`` preset, calibrated on the first warm-up batch), run
through the cell's own driver, traffic and judge at the cell's own size,
each seed in turn in one process. The comparison has to find it not
correct; the smallest reading of each number over the seeds is the upper
reading that the cell's limits lie below. ``--sides`` adds runs as the
cell states it (``sound``, the lower readings) and with the faults of
``benchmark/faults.py`` planted.

    python -m benchmark.control --workload <name> --seeds 11,12,13 --seconds 4 [--sides sound,control,...]

The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from . import run as R
from .drivers import detect_tiles
from .faults import FAULTS


def int8_detector(model_cfg, sd, device):
    """The cell's detector with the program's int8 path switched on."""
    return detect_tiles.build_detector(dict(model_cfg, quant_mode="int8"), sd, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--sides", default="control",
                        help="comma-separated: sound (as the cell states it), control, and the faults "
                             f"of benchmark/faults.py ({', '.join(FAULTS)})")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            if side in FAULTS:
                planted = FAULTS[side]()
            else:
                planted = contextlib.nullcontext({"sound": None, "control": int8_detector}[side])
            detail = {}
            with planted as factory:
                res = R.run_cell(args.workload, seed, args.seconds, False, make_detector=factory, detail=detail)
            numbers = {k: v["value"] for k, v in res["compared"].items()}
            print(json.dumps({"side": side, "seed": seed, "correct": res["correct"], "compared": numbers,
                              "distribution": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
