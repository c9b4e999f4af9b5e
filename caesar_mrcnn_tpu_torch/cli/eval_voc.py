"""Pascal-VOC AP evaluation CLI over groundtruths/ + detections/ txt dirs:
``python -m caesar_mrcnn_tpu_torch.cli.eval_voc -gt GT_DIR -det DET_DIR``.

The port of ``caesar_mrcnn_tpu/cli/eval_voc.py``: the same flags, the same
per-image txt format (GT rows ``class x1 y1 x2 y2``, detection rows
``class score x1 y1 x2 y2``), and the same ``results.txt`` and standard
output (per-class AP and mAP).

Where it differs: the JAX CLI also draws each class's precision-recall
curve to ``<class>.png`` unless ``--noplot`` is given. That needs
matplotlib, which the port does not use, so the port draws nothing and
logs a warning instead (drawing is ROADMAP item A16c).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .. import logger
from ..evalmetrics.voc import pascal_voc_metrics, read_padilla_dirs


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Pascal VOC AP over txt dirs.")
    parser.add_argument("-gt", "--gtfolder", required=True)
    parser.add_argument("-det", "--detfolder", required=True)
    parser.add_argument("-t", "--threshold", type=float, default=0.5)
    parser.add_argument(
        "-m", "--method", default="every_point",
        choices=["every_point", "eleven_point"],
    )
    parser.add_argument("-sp", "--savepath", default="results")
    parser.add_argument("--noplot", action="store_true", default=False,
                        help="accepted for the JAX CLI's argv; the port draws no plots")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    gts, dets = read_padilla_dirs(args.gtfolder, args.detfolder)
    results = pascal_voc_metrics(gts, dets, args.threshold, args.method)

    os.makedirs(args.savepath, exist_ok=True)
    lines = ["Object Detection Metrics", "", f"IOU threshold: {args.threshold}", ""]
    for cls, res in results.items():
        if cls == "mAP":
            continue
        lines.append(f"Class: {cls}")
        lines.append(f"AP: {100.0 * res['AP']:.2f}%")
        lines.append(
            f"Positives: {res['total_positives']}  TP: {res['total_TP']:.0f}"
            f"  FP: {res['total_FP']:.0f}"
        )
        lines.append("")
    if not args.noplot:
        logger.warning("eval_voc: no per-class precision-recall PNGs: drawing needs matplotlib, which the port "
                       "does not use (ROADMAP A16c); pass --noplot to silence this")
    lines.append(f"mAP: {100.0 * results['mAP']:.2f}%")
    out = "\n".join(lines)
    with open(os.path.join(args.savepath, "results.txt"), "w") as f:
        f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
