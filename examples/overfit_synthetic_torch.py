"""End-to-end learning smoke of the PyTorch port: overfit a small model on
a synthetic radio survey and check that detections emerge.

The survey comes from the port's ``data/synthetic.py`` (compact sources,
extended galaxies and sidelobes on beam-correlated noise), the training from
its ``train/trainer.py`` through ``TrainingPipeline``, the detections from its
``Detector``; then the int8 detect graph (``quant_mode="int8"``) on the
trained weights must recall the ground-truth sources the float graph
recalls, less one at most. It runs on the card unless ``--device cpu`` is
given.

Usage: python examples/overfit_synthetic_torch.py [--steps 150] [--device cuda]
       [--images 16] [--size 128] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASSES = {"sidelobe": 1, "source": 2, "galaxy": 3}


def make_survey(root: str, n_images: int, size: int, seed: int):
    """A synthetic survey written by ``data/synthetic.py::write_survey`` and
    loaded as a ``SourceDataset``."""
    from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset
    from caesar_mrcnn_tpu_torch.data.synthetic import write_survey

    ds = SourceDataset()
    ds.set_class_dict(CLASSES)
    if ds.load_data_from_json_list(write_survey(root, n_images, seed=seed, size=size)) != 0:
        raise RuntimeError(f"cannot load the survey under {root}")
    ds.prepare()
    return ds


def small_config(size: int, batch: int, **overrides):
    """The JAX example's model (the custom backbone at ``size``^2, f32,
    Adam), at a learning rate of 1e-4 where the JAX example takes 1e-3.
    From the settled weights of :func:`seeded_model`, Adam at 1e-3 makes
    the features the same for every image within 25 steps, in the JAX
    package as in the port (``tests/torch_overfit_compare.py --settle``);
    at 1e-4 the port recalled 46 of 58 ground-truth objects after 150
    steps on an H100."""
    from caesar_mrcnn_tpu_torch.config import detector_config

    kw = dict(
        backbone="custom", image_min_dim=size, image_max_dim=size, num_classes=4,
        class_names=("bkg", "sidelobe", "source", "galaxy"), images_per_device=batch,
        rpn_anchor_scales=(8, 16, 32, 64, 128), rpn_train_anchors_per_image=128, pre_nms_limit=1024,
        post_nms_rois_training=256, post_nms_rois_inference=128, train_rois_per_image=64, max_gt_instances=8,
        detection_max_instances=16, use_mini_mask=True, mini_mask_shape=(56, 56), optimizer="adam",
        learning_rate=1e-4, compute_dtype="float32", score_thr=0.5,
    )
    kw.update(overrides)
    return detector_config(**kw)


def seeded_model(cfg, seed: int = 0):
    """Random weights from ``seed`` (flax's default scheme), settled
    (``testing.settle_flax_weights``: the stem scaled by 1/255, so that the
    raw 0..255 pixels do not saturate every softmax). From the JAX
    example's unsettled weights at its 1e-3 neither framework recalls an
    object of the survey after 150 steps (``tests/torch_overfit_compare.py``)."""
    import torch

    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.testing import settle_flax_weights

    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(W.flax_to_state_dict(settle_flax_weights(W.state_dict_to_flax(model.state_dict()))))
    return model


def train(cfg, ds, steps: int, device, seed: int = 0, log_every: int = 25):
    """``steps`` train steps from :func:`seeded_model`; returns (model,
    first loss, last loss, ms per step)."""
    import torch

    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.train import trainer as T

    pipe = TrainingPipeline(ds, cfg, seed=seed)
    model = seeded_model(cfg, seed).to(device)
    step = T.make_train_step(model, T.make_optimizer(cfg, model), pipe.anchors_normalized())
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    batches = pipe.batches()
    t0 = time.time()
    first = last = None
    for i in range(steps):
        losses = step(T.batch_to_device(next(batches), device), generator=gen)
        if i == 0 or (i + 1) % log_every == 0 or i == steps - 1:
            last = float(losses["total_loss"])
            first = last if first is None else first
            print(f"step {i + 1}: total_loss={last:.4f}")
    return model, first, last, (time.time() - t0) / max(steps, 1) * 1000.0


def _iou(a, b) -> float:
    y1, x1 = max(a[0], b[0]), max(a[1], b[1])
    y2, x2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, y2 - y1) * max(0, x2 - x1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def gt_recall(det, ds, image_ids) -> tuple:
    """(GT objects recalled by a detection box at IoU > 0.3, GT objects)."""
    hit = total = 0
    for i in image_ids:
        r = det.detect([ds.load_image(i)])[0]
        gt, _ = ds.load_mask(i)
        for k in range(gt.shape[-1]):
            ys, xs = np.where(gt[..., k])
            if not len(ys):
                continue
            g = (ys.min(), xs.min(), ys.max(), xs.max())
            total += 1
            hit += any(_iou(g, b) > 0.3 for b in r["rois"])
    return hit, total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps_pos", nargs="?", type=int, help=argparse.SUPPRESS)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    steps = args.steps_pos or args.steps

    from caesar_mrcnn_tpu_torch.config import inference_config
    from caesar_mrcnn_tpu_torch.inference.detector import Detector

    cfg = small_config(args.size, 4)
    with tempfile.TemporaryDirectory() as tmp:
        ds = make_survey(tmp, args.images, args.size, args.seed)
        model, first, last, ms = train(cfg, ds, steps, args.device, args.seed)
        print(f"loss {first:.3f} -> {last:.3f} in {steps} steps, {ms:.0f} ms/step avg (device {args.device})")

        det = Detector(inference_config(cfg), model, args.device)
        n_det = 0
        for i in range(min(3, args.images)):
            r = det.detect([ds.load_image(i)])[0]
            good = [(int(c), round(float(s), 3)) for c, s in zip(r["class_ids"], r["scores"]) if s > 0.3]
            print(f"train image {i}: {len(r['class_ids'])} detections, {len(good)} with score>0.3 {good[:6]} "
                  f"(GT: {ds.load_mask(i)[0].shape[-1]})")
            n_det += len(good)
        print("OK: detections emerged" if n_det else "WARNING: no detections emerged yet (train longer)")

        # int8 on the trained weights: the quantized graph recalls the GT
        # sources the float graph recalls (less one at most)
        qdet = Detector(inference_config(cfg, quant_mode="int8"), model, args.device)
        ids = range(min(6, args.images))
        rec_f, n_gt = gt_recall(det, ds, ids)
        rec_q, _ = gt_recall(qdet, ds, ids)
        print(f"GT recall on the trained weights: f32 {rec_f}/{n_gt}, int8 {rec_q}/{n_gt}")
    if not last < first:
        raise SystemExit(f"the loss did not decrease: {first:.4f} -> {last:.4f}")
    if rec_q < rec_f - 1:
        raise SystemExit(f"the int8 graph lost GT recall: {rec_q}/{n_gt} against f32 {rec_f}/{n_gt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
