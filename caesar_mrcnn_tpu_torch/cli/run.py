"""Main CLI: ``python -m caesar_mrcnn_tpu_torch.cli.run [opts] {train,test,detect,export}``.

The port of ``caesar_mrcnn_tpu/cli/run.py`` on the port's modules: the same
flags with the same defaults, the same four run modes, dataset factories
and config overrides, and weights restored by name (``--weights``: a
``.pt`` checkpoint of the port or a Keras ``.h5``) with optional layer
exclusion.

It adds two flags:

* ``--device`` (default ``cuda``): the card, unless the caller asks for
  the CPU (``--device cpu``, where the kernels' plain versions run).
  ``cuda`` without a card raises; nothing falls back to the CPU;
* ``--telemetry FILE`` (``detect``): records the run's spans and counters
  (``telemetry.py``), writes their summary (``Recorder.summary()``, JSON)
  to ``FILE`` (``FILE.rank<r>`` from each rank of several processes) and
  logs one line of each span's total.

``--ngpu N`` (data parallelism, the JAX CLI's device mesh):

* ``train`` runs ``N`` data-parallel processes (``train/trainer.py``),
  global batch ``--nimg_per_gpu`` x ``N``, rank ``r`` on
  ``cuda:(LOCAL_RANK % cards)`` (``--ngpu 2`` on one card runs two ranks
  on it, over Gloo; a card per rank gets NCCL). Outside a launcher the
  CLI starts the ``N`` processes itself (``torch.multiprocessing``, spawn,
  a free localhost port); under ``torchrun`` its ``WORLD_SIZE`` must equal
  ``N``. Only rank 0 writes the checkpoints, ``train_metrics.jsonl`` and
  the log;
* ``detect`` and ``test`` in one process run the ``Detector`` over ``N``
  local devices (fewer, with a warning, when fewer exist); under a
  launcher (``WORLD_SIZE`` = ``N`` > 1) ``detect --split_img_in_tiles`` is
  the multi-process ``SFinder``, one card per rank.

Where it differs from the JAX CLI:

* what the port does not have yet is refused before any work is done,
  naming its ROADMAP item: ``detect --detect_outfile`` without
  ``--split_img_in_tiles`` (the overlay, A16c; on the tiled path both CLIs
  ignore the flag), and ``--roi_gather_dtype`` other than ``none`` (not to
  be ported);
* under a launcher of more than one process, a ``WORLD_SIZE`` other than
  ``--ngpu`` is refused, and so are ``test``, ``export`` and an untiled
  ``detect``, which one process runs over ``--ngpu`` devices;
* ``export --serving`` and ``export --quant_mode int8`` are refused: the
  int8 graph needs calibration images, which ``export`` has none of (the
  JAX CLI exports the float graph then); export a calibrated ``Detector``
  with ``inference.export.export_detector`` instead;
* ``export`` writes a ``torch.export`` artifact (``inference/export.py``),
  which runs on the kind of device it was exported on (``--device``);
* ``train --serving`` is refused (the serving preset is for test and
  detect; the JAX CLI applies it to training);
* an unknown class name or a threshold that is not a number in
  ``--scoreThrPerClass`` exits with the flag's error (the JAX CLI ignores
  the first and raises a bare ``ValueError`` for the second);
* ``train`` writes ``train_metrics.jsonl`` but no ``loss_curve.png``
  (matplotlib; ROADMAP A16c), and no XLA compile cache is set up.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
from typing import List, Optional

import numpy as np

from .. import logger, telemetry
from ..config import Config, detector_config, inference_config

DEFAULT_LOGS_DIR = "logs"


# ----------------------------------------------------------------- parsing


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train/evaluate/apply the radio-source Mask R-CNN (PyTorch port, CUDA)."
    )
    parser.add_argument(
        "command", metavar="<command>",
        help="'train', 'test', 'detect' or 'export'",
    )
    parser.add_argument("--export_path", type=str, default=None,
                        help="output path for the 'export' command")
    parser.add_argument("--telemetry", type=str, default=None, metavar="FILE",
                        help="detect: record the run's spans and counters and write their summary (JSON) to FILE")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: the card ('cuda', the default) unless 'cpu' is asked for")

    # COMMON OPTIONS
    parser.add_argument("--imgsize", type=int, default=256)
    parser.add_argument("--grayimg", action="store_true", default=False)
    parser.add_argument("--no_uint8", dest="to_uint8", action="store_false", default=True)
    parser.add_argument("--no_zscale", dest="zscale", action="store_false", default=True)
    parser.add_argument("--zscale_contrasts", type=str, default="0.25,0.25,0.25")
    parser.add_argument("--biascontrast", action="store_true", default=False)
    parser.add_argument("--bias", type=float, default=0.5)
    parser.add_argument("--contrast", type=float, default=1.0)
    parser.add_argument("--no_norm_img", dest="norm_img", action="store_false", default=True)

    parser.add_argument("--classdict", type=str, default='{"sidelobe":1,"source":2,"galaxy":3}')
    parser.add_argument("--classdict_model", type=str, default="")
    parser.add_argument("--remap_classids", action="store_true", default=False)
    parser.add_argument("--classid_remap_dict", type=str, default="")

    parser.add_argument("--dataloader", type=str, default="datalist",
                        choices=["datalist", "datalist_json", "datadir_json"])
    parser.add_argument("--datalist", default=None)
    parser.add_argument("--datalist_train", default=None)
    parser.add_argument("--datalist_val", default=None)
    parser.add_argument("--datadir", default=None)
    parser.add_argument("--validation_data_fract", type=float, default=0.1)
    parser.add_argument("--maxnimgs", type=int, default=-1)
    parser.add_argument("--weights", default=None,
                        help="weights to restore by name: a .pt checkpoint of the port or a Keras .h5")
    parser.add_argument("--logs", default=DEFAULT_LOGS_DIR)
    parser.add_argument("--nthreads", type=int, default=1)
    # Cross-epoch cache of decoded+resized training samples (GB, 0 disables)
    parser.add_argument("--data_cache_gb", type=float, default=4.0)

    # TRAIN OPTIONS
    parser.add_argument("--ngpu", type=int, default=1,
                        help="number of data-parallel devices: train runs one process per device, detect and "
                        "test one replica per device")
    parser.add_argument("--nimg_per_gpu", type=int, default=1)
    parser.add_argument("--nepochs", type=int, default=1)
    parser.add_argument("--epoch_length", type=int, default=None)
    parser.add_argument("--nvalidation_steps", type=int, default=None)
    parser.add_argument("--rpn_anchor_scales", type=str, default="4,8,16,32,64")
    parser.add_argument("--max_gt_instances", type=int, default=300)
    parser.add_argument("--backbone", type=str, default="resnet101")
    parser.add_argument("--backbone_strides", type=str, default="4,8,16,32,64")
    parser.add_argument("--rpn_nms_threshold", type=float, default=0.7)
    parser.add_argument("--rpn_train_anchors_per_image", type=int, default=512)
    parser.add_argument("--train_rois_per_image", type=int, default=512)
    parser.add_argument("--rpn_anchor_ratios", type=str, default="0.5,1,2")
    parser.add_argument(
        "--serving", action="store_true", default=False,
        help="serving preset for test/detect: int8 detect graph (calibrated on the first batch) + "
        "proposal budget pre_nms 3000 / post_nms_inference 512. Explicit "
        "--quant_mode/--pre_nms_limit/--post_nms_rois_inference flags override the preset.",
    )
    parser.add_argument("--pre_nms_limit", type=int, default=None)
    parser.add_argument("--post_nms_rois_training", type=int, default=2000)
    parser.add_argument("--post_nms_rois_inference", type=int, default=None)
    parser.add_argument("--detection_max_instances", type=int, default=100)
    parser.add_argument("--use_mini_mask", action="store_true", default=False)
    parser.add_argument("--rpn_class_loss_weight", type=float, default=1.0)
    parser.add_argument("--rpn_bbox_loss_weight", type=float, default=1.0)
    parser.add_argument("--mrcnn_class_loss_weight", type=float, default=1.0)
    parser.add_argument("--mrcnn_bbox_loss_weight", type=float, default=1.0)
    parser.add_argument("--mrcnn_mask_loss_weight", type=float, default=1.0)
    for name in ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                 "mrcnn_bbox_loss", "mrcnn_mask_loss"):
        parser.add_argument(f"--{name}", dest=name, action="store_true", default=True)
        parser.add_argument(f"--no_{name}", dest=name, action="store_false")
    parser.add_argument("--mask_loss_function", type=str, default="binary_crossentropy",
                        choices=["binary_crossentropy", "dice_coef_loss"])
    parser.add_argument("--roi_gather_dtype", type=str, default="none",
                        help="inference ROIAlign gather buffer dtype of the JAX package; the port "
                        "takes only 'none'")
    parser.add_argument("--quant_mode", type=str, default=None, choices=["none", "int8"],
                        help="post-training quantization of the detect graph: 'int8' calibrates "
                        "activation scales on the first batch and runs int8 convolutions")
    parser.add_argument("--train_wire", type=str, default="compact", choices=["compact", "dense"],
                        help="host->device training batch format: 'compact' ships sparse RPN targets, "
                        "bit-packed masks and mono images; 'dense' ships device-shaped arrays")
    parser.add_argument("--optimizer", type=str, default="adam", choices=["adam", "sgd"])
    parser.add_argument(
        "--grad_accum_steps", type=int, default=1,
        help="average grads over k micro-batches per optimizer update "
             "(effective batch = k * nimg_per_gpu * ngpu)",
    )
    parser.add_argument("--learning_rate", type=float, default=0.0005)
    parser.add_argument("--trainable_layers", type=str, default="all",
                        choices=["heads", "3+", "4+", "5+", "all"])
    parser.add_argument("--weight_classes", action="store_true", default=False)
    parser.add_argument("--exclude_first_layer_weights", action="store_true", default=False)
    parser.add_argument(
        "--exclude_layers", type=str, default="",
        help="comma-separated layer-name patterns to skip when restoring --weights (e.g. the COCO "
        "head set 'mrcnn_class_logits,mrcnn_bbox_fc,mrcnn_bbox,mrcnn_mask')",
    )
    parser.add_argument("--no_augmentation", dest="use_augmentation",
                        action="store_false", default=True)

    # TEST OPTIONS
    parser.add_argument("--scoreThr", type=float, default=0.7)
    parser.add_argument(
        "--scoreThrPerClass", default="sidelobe=0.9",
        help="per-class score-threshold overrides 'name=thr[,name=thr...]' "
        "(default: sidelobe at its measured F1 knee); 'none' restores the "
        "reference's single global --scoreThr",
    )
    parser.add_argument("--iouThr", type=float, default=0.6)
    # Parsed and set for compatibility; nothing reads it (as in the reference).
    parser.add_argument("--consider_sources_near_mixed_sidelobes",
                        action="store_true", default=True)
    parser.add_argument("--no_consider_sources_near_mixed_sidelobes",
                        dest="consider_sources_near_mixed_sidelobes", action="store_false")

    # DETECT OPTIONS
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--xmin", type=int, default=-1)
    parser.add_argument("--xmax", type=int, default=-1)
    parser.add_argument("--ymin", type=int, default=-1)
    parser.add_argument("--ymax", type=int, default=-1)
    parser.add_argument("--detect_outfile", type=str, default="")
    parser.add_argument("--detect_outfile_json", type=str, default="")

    # PARALLEL OPTIONS
    parser.add_argument("--split_img_in_tiles", action="store_true", default=False)
    parser.add_argument("--tile_xsize", type=int, default=512)
    parser.add_argument("--tile_ysize", type=int, default=512)
    parser.add_argument("--tile_xstep", type=float, default=1.0)
    parser.add_argument("--tile_ystep", type=float, default=1.0)
    parser.add_argument(
        "--tile_wire", choices=("u8", "raw", "slow"), default="u8",
        help="host->device wire for full-size tiles: fused-uint8 (default) or the "
             "legacy host chain ('raw' is not ported)",
    )

    return parser.parse_args(argv)


def validate_args(args) -> int:
    """0 when the arguments make a run, else -1 (logged)."""
    if args.command not in ("train", "test", "detect", "export"):
        logger.error("Unknown command %s", args.command)
        return -1
    if args.command == "export" and not args.export_path:
        logger.error("--export_path required for export")
        return -1
    if args.command == "train" and args.serving:
        logger.error("--serving is the serving preset of test and detect; it does not apply to train")
        return -1
    if args.command in ("train", "test"):
        if args.dataloader in ("datalist", "datalist_json"):
            has_list = args.datalist or (args.datalist_train and args.datalist_val)
            if not has_list:
                logger.error("--datalist (or train+val lists) required for %s", args.command)
                return -1
        elif args.dataloader == "datadir_json" and not args.datadir:
            logger.error("--datadir required for datadir_json loader")
            return -1
    if args.command == "detect" and not args.image:
        logger.error("--image required for detect")
        return -1
    return 0


def _quant_mode(args) -> str:
    return args.quant_mode if args.quant_mode is not None else ("int8" if args.serving else "none")


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for what the JAX CLI does and the port
    does not: not yet (naming its ROADMAP item), or not from the CLI (the
    int8 export)."""
    if args.command == "export" and _quant_mode(args) == "int8":
        raise NotImplementedError(
            "export of the int8 graph (--serving, --quant_mode int8): it needs calibration images, which the "
            "export command has none of; call inference.export.export_detector on a Detector after "
            "Detector.quantize(images)"
        )
    if args.command == "detect" and args.detect_outfile and not args.split_img_in_tiles:
        raise NotImplementedError(
            f"--detect_outfile {args.detect_outfile}: the detection overlay needs matplotlib, which the port does "
            "not use; drawing waits for ROADMAP item A16c (with --split_img_in_tiles the flag is ignored, as the "
            "JAX CLI ignores it)"
        )
    if args.roi_gather_dtype != "none":
        raise NotImplementedError(
            f"--roi_gather_dtype {args.roi_gather_dtype}: the JAX package's reduced-precision ROIAlign "
            "gather is on the ROADMAP's 'Not to port' list; the port takes only 'none'"
        )


def check_launcher(args, world_size: int) -> None:
    """Under a launcher of ``world_size`` > 1 processes: one process per
    device, so ``--ngpu`` must count them, and only ``train`` and tiled
    ``detect`` run there."""
    if world_size != args.ngpu:
        raise ValueError(
            f"the launcher's WORLD_SIZE={world_size} differs from --ngpu {args.ngpu}: under a launcher the CLI "
            f"runs one process per device; pass --ngpu {world_size}"
        )
    if not (args.command == "train" or (args.command == "detect" and args.split_img_in_tiles)):
        raise ValueError(
            f"{args.command}{'' if args.command != 'detect' else ' without --split_img_in_tiles'} runs in one "
            f"process: run it without a launcher, with --ngpu {args.ngpu} to use {args.ngpu} local devices"
        )


def check_device(device: str) -> None:
    """A CUDA device must exist: the port never carries on on the CPU
    unless asked for it."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available (pass --device cpu to run on the CPU)")


# ------------------------------------------------------------------ config


def _parse_score_thr_per_class(spec: str, class_names=None):
    """'name=thr[,name=thr...]' -> ((name, thr), ...); '', 'none' -> ().
    A name outside ``class_names`` (when given), an item without '=' or a
    threshold that is not a number exits with the flag's error."""
    spec = (spec or "").strip()
    if not spec or spec.lower() == "none":
        return ()
    out = []
    for item in spec.split(","):
        name, _, thr = item.partition("=")
        name = name.strip()
        if not _ or not name:
            raise SystemExit(f"--scoreThrPerClass: bad item {item!r} (want name=thr)")
        if class_names is not None and name not in class_names:
            raise SystemExit(f"--scoreThrPerClass: unknown class {name!r} (classes: {', '.join(class_names)})")
        try:
            value = float(thr)
        except ValueError:
            raise SystemExit(f"--scoreThrPerClass: threshold {thr!r} of {name!r} is not a number") from None
        out.append((name, value))
    return tuple(out)


def build_config(args) -> Config:
    """argparse -> Config."""
    class_dict = json.loads(args.classdict_model or args.classdict)
    names = ["bkg"] + [None] * len(class_dict)
    for name, cid in class_dict.items():
        names[cid] = name
    class_names = tuple(n or f"class{i}" for i, n in enumerate(names))

    cfg = detector_config(
        num_classes=len(class_names),
        class_names=class_names,
        image_min_dim=args.imgsize,
        image_max_dim=args.imgsize,
        num_devices=args.ngpu,
        images_per_device=args.nimg_per_gpu,
        rpn_anchor_scales=tuple(int(v) for v in args.rpn_anchor_scales.split(",")),
        rpn_anchor_ratios=tuple(float(v) for v in args.rpn_anchor_ratios.split(",")),
        backbone=args.backbone,
        backbone_strides=tuple(int(v) for v in args.backbone_strides.split(",")),
        rpn_nms_threshold=args.rpn_nms_threshold,
        rpn_train_anchors_per_image=args.rpn_train_anchors_per_image,
        train_rois_per_image=args.train_rois_per_image,
        max_gt_instances=args.max_gt_instances,
        # the --serving preset gives the serving-side defaults; explicit flags win
        pre_nms_limit=(
            args.pre_nms_limit if args.pre_nms_limit is not None else (3000 if args.serving else 6000)),
        post_nms_rois_training=args.post_nms_rois_training,
        post_nms_rois_inference=(
            args.post_nms_rois_inference
            if args.post_nms_rois_inference is not None
            else (512 if args.serving else 1000)),
        detection_max_instances=args.detection_max_instances,
        use_mini_mask=args.use_mini_mask,
        image_channel_count=1 if args.grayimg else 3,
        mean_pixel=(0.0,) if args.grayimg else (0.0, 0.0, 0.0),
        optimizer=args.optimizer,
        grad_accum_steps=args.grad_accum_steps,
        learning_rate=args.learning_rate,
        roi_gather_dtype=args.roi_gather_dtype,
        quant_mode=_quant_mode(args),
        train_wire=args.train_wire,
        mask_loss_function=args.mask_loss_function,
        loss_weights={
            "rpn_class_loss": args.rpn_class_loss_weight,
            "rpn_bbox_loss": args.rpn_bbox_loss_weight,
            "mrcnn_class_loss": args.mrcnn_class_loss_weight,
            "mrcnn_bbox_loss": args.mrcnn_bbox_loss_weight,
            "mrcnn_mask_loss": args.mrcnn_mask_loss_weight,
        },
        use_losses={
            "rpn_class_loss": args.rpn_class_loss,
            "rpn_bbox_loss": args.rpn_bbox_loss,
            "mrcnn_class_loss": args.mrcnn_class_loss,
            "mrcnn_bbox_loss": args.mrcnn_bbox_loss,
            "mrcnn_mask_loss": args.mrcnn_mask_loss,
        },
        zscale_stretch=args.zscale,
        zscale_contrasts=tuple(float(v) for v in args.zscale_contrasts.split(",")),
        normalize_img=args.norm_img,
        img_to_uint8=args.to_uint8,
        img_to_rgb=not args.grayimg,
        bias_contrast_stretch=args.biascontrast,
        img_bias=args.bias,
        img_contrast=args.contrast,
        score_thr=args.scoreThr,
        score_thr_per_class=_parse_score_thr_per_class(args.scoreThrPerClass, class_names),
        iou_thr=args.iouThr,
        split_img_in_tiles=args.split_img_in_tiles,
        tile_xsize=args.tile_xsize,
        tile_ysize=args.tile_ysize,
        tile_xstep=args.tile_xstep,
        tile_ystep=args.tile_ystep,
        tile_wire=args.tile_wire,
    )
    return cfg


# ----------------------------------------------------------------- datasets


def _make_dataset(args, cfg: Config):
    from ..data.dataset import SourceDataset

    ds = SourceDataset()
    ds.set_class_dict(json.loads(args.classdict))
    ds.apply_zscale = args.zscale
    ds.zscale_contrasts = [float(v) for v in args.zscale_contrasts.split(",")]
    ds.convert_to_uint8 = args.to_uint8
    ds.convert_to_rgb = not args.grayimg
    ds.apply_biascontrast = args.biascontrast
    ds.bias = args.bias
    ds.contrast = args.contrast
    return ds


def create_train_val_datasets(args, cfg: Config, comm=None):
    """The train and validation datasets. A ``--datalist`` alone is split
    at random into ``train.dat`` and ``crossval.dat`` in the working
    directory; with a communicator of several ranks every rank makes rank
    0's split (its seed), the others writing their list files to a
    temporary directory of their own."""
    import tempfile

    from ..data.dataset import create_train_val_sets_from_list

    train_list, val_list = args.datalist_train, args.datalist_val
    with tempfile.TemporaryDirectory() as own:
        if args.dataloader in ("datalist", "datalist_json") and args.datalist and not train_list:
            with open(args.datalist) as f:
                rows = [r for r in f.read().splitlines() if r.strip()]
            seed, files = None, {}
            if comm is not None and comm.size > 1:
                seed = comm.allgather(int(np.random.randint(2 ** 31)))[0]
                if comm.rank:
                    files = {"train_filename": os.path.join(own, "train.dat"),
                             "crossval_filename": os.path.join(own, "crossval.dat")}
            train_list, val_list = create_train_val_sets_from_list(
                rows, crossval_size=args.validation_data_fract, seed=seed, **files)
        return _load_train_val(args, cfg, train_list, val_list)


def _load_train_val(args, cfg: Config, train_list, val_list):
    ds_train = _make_dataset(args, cfg)
    ds_val = _make_dataset(args, cfg)
    if args.dataloader == "datalist":
        ds_train.load_data_from_list(train_list, args.maxnimgs)
        ds_val.load_data_from_list(val_list, args.maxnimgs)
    elif args.dataloader == "datalist_json":
        ds_train.load_data_from_json_list(train_list, args.maxnimgs)
        ds_val.load_data_from_json_list(val_list, args.maxnimgs)
    elif args.dataloader == "datadir_json":
        ds_train.load_data_from_json_search(args.datadir, args.maxnimgs)
        ds_val.load_data_from_json_search(args.datadir, args.maxnimgs)
    for ds in (ds_train, ds_val):
        if args.weight_classes:
            ds.compute_class_weights()
        ds.prepare()
    return ds_train, ds_val


def create_test_dataset(args, cfg: Config):
    ds = _make_dataset(args, cfg)
    if args.dataloader == "datalist":
        ds.load_data_from_list(args.datalist, args.maxnimgs)
    elif args.dataloader == "datalist_json":
        ds.load_data_from_json_list(args.datalist, args.maxnimgs)
    elif args.dataloader == "datadir_json":
        ds.load_data_from_json_search(args.datadir, args.maxnimgs)
    ds.prepare()
    return ds


# ------------------------------------------------------------- processes


def _rank_main(local_rank: int, argv: List[str], world_size: int, port: int, threads: int) -> None:
    """One spawned data-parallel rank: the launcher's variables, then
    :func:`main` as under ``torchrun``."""
    import torch

    os.environ.update({"RANK": str(local_rank), "LOCAL_RANK": str(local_rank), "WORLD_SIZE": str(world_size),
                       "LOCAL_WORLD_SIZE": str(world_size), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    torch.set_num_threads(threads)
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def spawn_ranks(argv: List[str], n: int) -> int:
    """Run ``argv`` as ``n`` data-parallel processes on this host (spawned,
    on a free localhost port), as ``torchrun --nproc-per-node n`` would;
    a rank that fails raises here."""
    import torch
    import torch.multiprocessing as mp

    from ..parallel.dist import free_port

    threads = max(1, torch.get_num_threads() // n)
    mp.start_processes(_rank_main, args=(list(argv), n, free_port(), threads), nprocs=n, join=True,
                       start_method="spawn")
    return 0


# --------------------------------------------------------------- run modes


def _exclude_patterns(args) -> Optional[List[str]]:
    """Layer-name exclusion list for the --weights restore."""
    patterns = [p.strip() for p in args.exclude_layers.split(",") if p.strip()]
    if args.exclude_first_layer_weights:
        patterns.append("conv1")
    return patterns or None


def run_train(args, cfg: Config) -> int:
    """Train ``--nepochs`` epochs of ``--epoch_length`` micro-steps; every
    epoch, validation losses and a ``mask_rcnn_<name>_NNNN.pt`` checkpoint."""
    import torch
    import torch.distributed as dist

    from .. import weights as W
    from ..data.generator import TrainingPipeline
    from ..models.mask_rcnn import MaskRCNN
    from ..parallel.dist import get_comm
    from ..parallel.mesh import shard_rows
    from ..train import checkpoints as CKPT
    from ..train.observability import MetricsLogger
    from ..train.trainer import (broadcast_parameters, make_eval_step, make_optimizer, make_train_step,
                                 train_loop)

    device = torch.device(args.device)
    # data parallelism: this process is one rank of the group (the launcher's or spawn_ranks's)
    comm = get_comm()
    group = dist.group.WORLD if comm.size > 1 else None
    rows = shard_rows(cfg.batch_size, comm.size, comm.rank) if group is not None else None
    ds_train, ds_val = create_train_val_datasets(args, cfg, comm)
    n_train = ds_train.num_images
    steps_per_epoch = args.epoch_length or max(1, n_train // cfg.batch_size)
    # every epoch, nvalidation_steps forward-only loss batches of the val split
    val_steps = args.nvalidation_steps
    if val_steps is None:
        val_steps = max(1, ds_val.num_images // cfg.batch_size) if ds_val.num_images else 0
    logger.info(
        "training on %d images, %d steps/epoch (+%d val steps/epoch on %d images) on %s",
        n_train, steps_per_epoch, val_steps, ds_val.num_images, device,
    )

    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(0))
    start_epoch = 0
    if args.weights:
        CKPT.restore_weights(model, args.weights, exclude=_exclude_patterns(args))
        start_epoch = CKPT.epoch_from_path(args.weights)
    model.to(device)
    if group is not None:
        broadcast_parameters(model, group)  # every rank starts from rank 0's weights
    optimizer = make_optimizer(cfg, model, layers=args.trainable_layers)

    cache_bytes = int(args.data_cache_gb * (1 << 30))
    pipeline = TrainingPipeline(
        ds_train, cfg, augmentation=args.use_augmentation, seed=0,
        num_workers=args.nthreads, cache_bytes=cache_bytes,
    )
    class_weights = None
    if args.weight_classes and ds_train.class_weights:
        class_weights = np.ones(cfg.num_classes, np.float32)
        for cid, w in ds_train.class_weights.items():
            if 0 <= int(cid) < cfg.num_classes:
                class_weights[int(cid)] = w
        logger.info("class weights: %s", class_weights.tolist())
    anchors = pipeline.anchors_normalized()
    step = make_train_step(model, optimizer, anchors, class_weights=class_weights, group=group)

    val_pipeline, val_step = None, None
    if val_steps:
        val_pipeline = TrainingPipeline(
            ds_val, cfg, augmentation=False, seed=1, num_workers=args.nthreads, cache_bytes=cache_bytes,
        )
        val_step = make_eval_step(model, anchors, class_weights=class_weights, group=group)

    batches = pipeline.prefetch(device=device, rows=rows)
    val_batches = val_pipeline.prefetch(device=device, rows=rows) if val_pipeline is not None else None
    # on every rank the same generator: the sampling priorities are drawn for the global batch
    generator = torch.Generator(device=device).manual_seed(42)
    master = comm.rank == 0
    if master:
        os.makedirs(args.logs, exist_ok=True)
    metrics = MetricsLogger(args.logs) if master else None
    try:
        for epoch in range(start_epoch, start_epoch + args.nepochs):
            losses = train_loop(
                step, batches, steps_per_epoch, device, generator=generator,
                callback=(lambda s, ls, e=epoch: metrics.log(e * steps_per_epoch + s, ls)) if master else None,
            )
            if val_steps:
                # the same target sampling every epoch
                val_generator = torch.Generator(device=device).manual_seed(7)
                sums: dict = {}
                for _ in range(val_steps):
                    vl = val_step(next(val_batches), generator=val_generator)
                    for k, v in vl.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                val_losses = {f"val_{k}": v / val_steps for k, v in sums.items()}
                if master:
                    metrics.log((epoch + 1) * steps_per_epoch, val_losses)
                logger.info("epoch %d validation: %s", epoch + 1, {k: round(v, 4) for k, v in val_losses.items()})
            if master:
                path = CKPT.save_checkpoint(args.logs, cfg.name, epoch + 1, model)
                logger.info("epoch %d done, checkpoint: %s (losses=%s)", epoch + 1, path, losses)
            comm.barrier()
    finally:
        batches.close()
        if val_batches is not None:
            val_batches.close()
    return 0


def _build_detector(args, cfg: Config):
    from ..inference.detector import build_detector

    # --nimg_per_gpu carries through, so that ModelTester's evaluation and
    # SFinder's tile inference run in batches of that size; --ngpu devices
    # in one process, or one per rank under a launcher
    from ..parallel.dist import world_size

    ndev = 1 if world_size() > 1 else max(1, args.ngpu)
    icfg = inference_config(cfg, images_per_device=max(1, args.nimg_per_gpu), num_devices=ndev)
    return build_detector(icfg, weights_path=args.weights, exclude=_exclude_patterns(args), device=args.device)


def run_test(args, cfg: Config) -> int:
    from ..analysis.tester import ModelTester

    ds = create_test_dataset(args, cfg)
    detector = _build_detector(args, cfg)
    tester = ModelTester(detector, detector.config, ds)
    os.makedirs(args.logs, exist_ok=True)
    tester.outdir = args.logs  # CSVs + eval dumps go to the job dir
    tester.n_max_img = args.maxnimgs
    if args.remap_classids and args.classid_remap_dict:
        remap = json.loads(args.classid_remap_dict)
        tester.classid_remap_dict = {int(k): int(v) for k, v in remap.items()}
    return tester.test()


def run_export(args, cfg: Config) -> int:
    """Export the (optionally weight-restored) detect graph as a
    self-contained serving artifact (``inference/export.py``)."""
    from ..inference.export import export_detector

    export_detector(_build_detector(args, cfg), args.export_path)
    return 0


def run_detect(args, cfg: Config) -> int:
    from ..analysis.sfinder import SFinder

    # Rectangular tiles run the detector at the exact (tile_ysize,
    # tile_xsize) on the fast wire; with non-default preprocessing knobs
    # tiles go through the square-molding detect() path (the same gate as
    # SFinder.run_tiled).
    fast_wire = (
        cfg.zscale_stretch
        and not cfg.bias_contrast_stretch
        and cfg.img_to_rgb
        and cfg.img_to_uint8
        and len(set(cfg.zscale_contrasts)) == 1
        and cfg.tile_wire in ("u8", "raw")
    )
    if cfg.split_img_in_tiles and fast_wire:
        # the FPN's top-down path 2x-upsamples P5..P2: every halving down to
        # stride 64 must be exact for the raw tile shape
        for name, v in (("tile_xsize", cfg.tile_xsize), ("tile_ysize", cfg.tile_ysize)):
            if v % 64 != 0:
                raise ValueError(
                    f"{name}={v} must be divisible by 64 for tiled detect "
                    "(FPN needs 6 exact stride halvings); pick e.g. "
                    f"{(v // 64 + 1) * 64}"
                )
    detector = _build_detector(
        args, cfg.replace(
            image_min_dim=min(cfg.tile_xsize, cfg.tile_ysize),
            image_max_dim=max(cfg.tile_xsize, cfg.tile_ysize),
            input_shape_override=((cfg.tile_ysize, cfg.tile_xsize) if fast_wire else None),
        )
        if cfg.split_img_in_tiles else cfg
    )
    sf = SFinder(detector, detector.config)
    sf.outfile_json = args.detect_outfile_json
    sf.outfile_img = args.detect_outfile
    with telemetry.recording() if args.telemetry else contextlib.nullcontext() as rec:
        if cfg.split_img_in_tiles:
            sf.run_tiled(args.image)
        else:
            sf.run(args.image, xmin=args.xmin, xmax=args.xmax, ymin=args.ymin, ymax=args.ymax)
    if rec is not None:
        summary = rec.summary()
        path = args.telemetry if sf.comm.size == 1 else f"{args.telemetry}.rank{sf.comm.rank}"
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)
        logger.info("telemetry (%d batches; total ms): %s -> %s", summary["batches"],
                    ", ".join(f"{name} {row['total_ms']:.1f}" for name, row in sorted(summary["spans"].items())),
                    path)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if validate_args(args) < 0:
        return 1
    refuse_unported(args)
    from ..parallel.dist import get_comm, init_from_env, launcher_env

    env = launcher_env()
    if env is not None and env["world_size"] > 1:
        import torch.distributed as dist

        check_launcher(args, env["world_size"])
        check_device(args.device)
        args.device = str(init_from_env(args.device))  # this rank's device
        if env["rank"] != 0:
            logger.setLevel(logging.WARNING)  # rank 0 logs the run
        try:
            rc = run_mode(args)
            get_comm().barrier()  # no rank tears the group down while another still uses it
            return rc
        finally:
            dist.destroy_process_group()
    check_device(args.device)
    if args.command == "train" and args.ngpu > 1:
        return spawn_ranks(argv if argv is not None else sys.argv[1:], args.ngpu)
    return run_mode(args)


def run_mode(args) -> int:
    """The run mode of ``args`` in this process."""
    cfg = build_config(args)
    logger.info(cfg.display())
    if args.command == "train":
        return run_train(args, cfg)
    if args.command == "test":
        return run_test(args, cfg)
    if args.command == "detect":
        return run_detect(args, cfg)
    if args.command == "export":
        return run_export(args, cfg)
    return 1


if __name__ == "__main__":
    sys.exit(main())
