"""Full train -> evaluate cycle of the PyTorch port on a 3-class synthetic
radio survey.

Trains the detector on a survey from the port's ``data/synthetic.py``
(compact sources, extended galaxies, sidelobes), then runs the complete
``ModelTester`` evaluation (confusion matrix, completeness/reliability
CSVs, mAP in all three evaluator formats) on a held-out survey of another
seed. It runs on the card unless ``--device cpu`` is given.

Usage: python examples/train_eval_synthetic_torch.py [--steps 2000] [--device cuda]
       [--train-images 48] [--test-images 16] [--size 128] [--workers 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.overfit_synthetic_torch import make_survey, seeded_model, small_config  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps_pos", nargs="?", type=int, help=argparse.SUPPRESS)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--train-images", type=int, default=48)
    p.add_argument("--test-images", type=int, default=16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=4, help="sample threads of the pipeline's prefetch")
    args = p.parse_args(argv)
    steps = args.steps_pos or args.steps

    import torch

    from caesar_mrcnn_tpu_torch.analysis.tester import ModelTester
    from caesar_mrcnn_tpu_torch.config import inference_config
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.inference.detector import Detector
    from caesar_mrcnn_tpu_torch.train import trainer as T

    cfg = small_config(args.size, args.batch, train_rois_per_image=100, iou_thr=0.5)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        print("workdir:", work)
        ds_train = make_survey(os.path.join(work, "train"), args.train_images, args.size, seed=0)
        ds_test = make_survey(os.path.join(work, "test"), args.test_images, args.size, seed=999)

        pipe = TrainingPipeline(ds_train, cfg, seed=0, augmentation=True, num_workers=args.workers)
        model = seeded_model(cfg).to(args.device)
        step = T.make_train_step(model, T.make_optimizer(cfg, model), pipe.anchors_normalized())
        gen = torch.Generator(device=args.device).manual_seed(1)
        batches = pipe.prefetch(device=args.device if args.device != "cpu" else None)
        t0 = time.time()
        try:
            for i in range(steps):
                losses = step(T.batch_to_device(next(batches), args.device), generator=gen)
                if (i + 1) % 200 == 0 or i == steps - 1:
                    print(f"step {i + 1}: total_loss={float(losses['total_loss']):.3f}")
        finally:
            batches.close()
        print(f"trained {steps} steps in {time.time() - t0:.0f}s on {args.device}")

        icfg = inference_config(cfg, images_per_device=4)
        det = Detector(icfg, model, args.device)
        os.chdir(work)
        try:
            tester = ModelTester(det, icfg, ds_test)
            tester.outdir = work
            tester.test()
            perf = tester.compute_performances()
            print("confusion matrix (rows=true, cols=pred):")
            print(tester.classification_matrix.astype(int))
            print("completeness per class:", np.round(perf["completeness"], 3))
            print("reliability per class:", np.round(perf["reliability"], 3))
            summary = tester.compute_mAP()
            print("VOC per-class AP:", {k: round(v, 3) for k, v in summary["voc"].items()})
            print("matterport mAP@0.5:", round(summary["matterport_mAP@0.5"], 3))
        finally:
            os.chdir(cwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
