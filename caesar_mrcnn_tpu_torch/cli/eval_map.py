"""COCO-style mAP CLI over ground_truth_boxes.json / predicted_boxes.json:
``python -m caesar_mrcnn_tpu_torch.cli.eval_map --gt GT.json --pred PRED.json``.

The port of ``caesar_mrcnn_tpu/cli/eval_map.py``: the same flags, json
formats and standard output (AP per IoU threshold and the averaged mAP).

Where it differs: ``--plot PATH`` (the JAX CLI draws the precision-recall
curves there) needs matplotlib, which the port does not use; it is refused
with ``NotImplementedError`` before any file is read (drawing is ROADMAP
item A16c).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

from ..evalmetrics.coco import coco_map


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="COCO-style mAP from box jsons.")
    parser.add_argument("--gt", default="ground_truth_boxes.json")
    parser.add_argument("--pred", default="predicted_boxes.json")
    parser.add_argument("--iou_start", type=float, default=0.5)
    parser.add_argument("--iou_end", type=float, default=0.75)
    parser.add_argument("--iou_step", type=float, default=0.05)
    parser.add_argument("--plot", type=str, default="",
                        help="refused by the port: drawing needs matplotlib (ROADMAP A16c)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.plot:
        raise NotImplementedError(
            f"--plot {args.plot}: the precision-recall plot needs matplotlib, which the port does not use; "
            "drawing waits for ROADMAP item A16c"
        )
    with open(args.gt) as f:
        gt = json.load(f)
    with open(args.pred) as f:
        pred = json.load(f)
    thrs = np.arange(args.iou_start, args.iou_end + 1e-9, args.iou_step)
    out = coco_map(gt, pred, thrs)
    for t, ap in out["per_iou"].items():
        print(f"AP@IoU={t:.2f}: {ap:.4f}")
    print(f"mAP: {out['mAP']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
