"""Source-classification CLI:
``python -m caesar_mrcnn_tpu_torch.cli.sclassifier --image img.fits --scatalog cat.dat``
(console script ``caesar-sclassifier-torch``).

The port of ``caesar_mrcnn_tpu/cli/sclassifier.py``: the same flags and
defaults, a 4+1-class inference config at the cutout size, the detector
built by the port's ``build_detector`` (``--weights``: a ``.pt``
checkpoint of the port or a Keras ``.h5``), and
``SClassifier.run(image, scatalog)``.

It adds ``--device`` (default ``cuda``): the card, unless the caller asks
for the CPU (``--device cpu``, where the kernels' plain versions run).
``cuda`` without a card raises; nothing falls back to the CPU.

Where it differs from the JAX CLI: a ``--scutout_size`` that is not a
multiple of 64 is refused before any image, catalog or weight is read.
Both CLIs mold the cutout to ``image_min_dim = image_max_dim =
scutout_size``, and the FPN's top-down path adds each level to the 2x
upsampled level above it, which needs every halving down to stride 64
exact: at the JAX CLI's default of 132 the add meets a 10 x 10 map and a
9 x 9 one, and the JAX package fails there (its own ``pad64`` molding
asserts the same rule for ``min_dim``, ``utils/image.py:97``). The default
stays 132, as the JAX CLI's, so the port refuses it: pass a multiple of
64, such as 128.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .. import logger
from ..config import detector_config, inference_config
from .run import check_device

# reference 4+1 classes (reference: scripts/sclassifier.py:46-47)
DEFAULT_CLASSDICT = '{"spurious":1,"compact":2,"extended":3,"extended-multisland":4}'


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Classify pre-detected radio sources (PyTorch port, CUDA).")
    parser.add_argument("--image", required=True, type=str, help="Input FITS image")
    parser.add_argument("--scatalog", required=True, type=str, help="Caesar ascii catalog")
    parser.add_argument("--weights", default=None, type=str,
                        help="weights to restore by name: a .pt checkpoint of the port or a Keras .h5")
    parser.add_argument("--classdict", type=str, default=DEFAULT_CLASSDICT)
    parser.add_argument("--scutout_size", type=int, default=132,
                        help="cutout side in pixels; the port takes multiples of 64 only")
    parser.add_argument("--scoreThr", type=float, default=0.7)
    parser.add_argument("--iouThr", type=float, default=0.6)
    parser.add_argument("--nmax", type=int, default=-1)
    parser.add_argument("--outfile", type=str, default="sclass_catalog.dat")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: the card ('cuda', the default) unless 'cpu' is asked for")
    return parser.parse_args(argv)


def check_cutout_size(size: int) -> None:
    """The cutout is molded to ``size`` x ``size``; the FPN needs it to be
    a positive multiple of 64."""
    if size <= 0 or size % 64:
        raise ValueError(
            f"--scutout_size {size}: the cutout is molded to {size} x {size}, and the FPN's top-down add needs "
            "every halving down to stride 64 to be exact, so the size must be a multiple of 64 (the JAX "
            "package's rule for min_dim, caesar_mrcnn_tpu/utils/image.py:97; at 132 its add meets a 10 x 10 "
            f"map and a 9 x 9 one); pick e.g. {max(64, size // 64 * 64)}"
        )


def main(argv: Optional[List[str]] = None) -> int:
    from ..analysis.classifier import SClassifier
    from ..inference.detector import build_detector

    args = parse_args(argv)
    check_cutout_size(args.scutout_size)
    check_device(args.device)
    class_dict = json.loads(args.classdict)
    names = ["bkg"] + [None] * len(class_dict)
    for name, cid in class_dict.items():
        names[cid] = name
    cfg = inference_config(
        detector_config(
            num_classes=len(names),
            class_names=tuple(n or f"class{i}" for i, n in enumerate(names)),
            image_min_dim=args.scutout_size,
            image_max_dim=args.scutout_size,
            score_thr=args.scoreThr,
            iou_thr=args.iouThr,
        )
    )
    detector = build_detector(cfg, weights_path=args.weights, device=args.device)
    sc = SClassifier(detector, cfg)
    sc.scutout_size = args.scutout_size
    sc.n_max_sources = args.nmax
    if sc.run(args.image, args.scatalog) < 0:
        return 1
    sc.write_catalog(args.outfile)
    logger.info("classification catalog written to %s", args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
