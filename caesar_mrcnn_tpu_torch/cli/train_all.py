"""Legacy single-mask trainer CLI (compat shim), the port of
``caesar_mrcnn_tpu/cli/train_all.py`` on the port's ``cli.run``.

It keeps the reference's legacy flag surface (scripts/train_all.py,
scripts/train_all_gpu.py) and maps it onto the main CLI's argv
(:func:`translate`, the same as the JAX package's):

* the legacy dataset is one ``img,mask,label`` line per image with a
  single binary FITS mask: the ``datalist`` loader;
* the legacy trainers use the same filelist for training and validation;
* ``--weighttype coco`` excludes the class-count-dependent head layers on
  restore;
* 256^2 square resize, RPN NMS threshold 0.9, 2 images per device.

``--ngpu`` above 1 is refused by ``cli.run`` (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .. import logger

COCO_HEAD_EXCLUDE = "mrcnn_class_logits,mrcnn_bbox_fc,mrcnn_bbox,mrcnn_mask"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Legacy single-mask-per-image trainer (compat wrapper "
        "over the port's main CLI, caesar_mrcnn_tpu_torch.cli.run)."
    )
    parser.add_argument("command", metavar="<command>", help="'train' or 'test'")
    parser.add_argument("--dataset", required=False,
                        help="filelist with img,mask,label rows")
    parser.add_argument("--weights", required=False, default="",
                        help="path to weights (.h5 or checkpoint); '' trains "
                        "from scratch")
    parser.add_argument("--logs", required=False, default="logs/",
                        help="logs and checkpoints directory")
    parser.add_argument("--nepochs", type=int, default=10)
    parser.add_argument("--epoch_length", type=int, default=10)
    parser.add_argument("--nvalidation_steps", type=int, default=50)
    parser.add_argument("--ngpu", type=int, default=1)
    parser.add_argument("--nimg_per_gpu", type=int, default=2)
    parser.add_argument("--weighttype", default="",
                        help="'coco' excludes the class-count head layers "
                        "on restore")
    parser.add_argument("--nthreads", type=int, default=1)
    parser.add_argument("--nimg_test", type=int, default=-1)
    parser.add_argument("--scoreThr_test", type=float, default=0.7)
    parser.add_argument("--iouThr_test", type=float, default=0.6)
    return parser.parse_args(argv)


def translate(args: argparse.Namespace) -> List[str]:
    """Map the legacy flag surface onto the modern CLI's argv."""
    if args.command not in ("train", "test"):
        raise ValueError(
            f"'{args.command}' is not recognized. Use 'train' or 'test'"
        )
    if not args.dataset:
        raise ValueError(f"Argument --dataset is required for {args.command}")

    argv = [
        args.command,
        "--dataloader", "datalist",
        "--imgsize", "256",
        "--rpn_nms_threshold", "0.9",
        "--logs", args.logs,
        "--nthreads", str(args.nthreads),
    ]
    if args.command == "train":
        argv += [
            "--datalist_train", args.dataset,
            "--datalist_val", args.dataset,
            "--nepochs", str(args.nepochs),
            "--epoch_length", str(args.epoch_length),
            "--nvalidation_steps", str(args.nvalidation_steps),
            "--ngpu", str(args.ngpu),
            "--nimg_per_gpu", str(args.nimg_per_gpu),
        ]
    else:
        argv += [
            "--datalist", args.dataset,
            "--maxnimgs", str(args.nimg_test),
            "--scoreThr", str(args.scoreThr_test),
            "--iouThr", str(args.iouThr_test),
        ]
    if args.weights:
        argv += ["--weights", args.weights]
        if args.weighttype.lower() == "coco":
            argv += ["--exclude_layers", COCO_HEAD_EXCLUDE]
    return argv


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        run_argv = translate(args)
    except ValueError as exc:
        logger.error(str(exc))
        return 1
    from . import run as cli_run

    return cli_run.main(run_argv)


if __name__ == "__main__":
    sys.exit(main())
