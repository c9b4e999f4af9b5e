"""The overfit example's learning in the JAX package and in the port, side
by side on the CPU at the example's size (``examples/overfit_synthetic_torch.py``:
the custom backbone, 128^2, batch 4, f32) at the JAX example's rate (Adam
1e-3): the same synthetic survey (``data/synthetic.py``), the same
starting weights (the JAX
package's ``init_model``, copied into the port; ``--settle`` applies
``testing.settle_flax_weights`` to both), the same batches.

Prints for each framework the loss along the way, the spread of the
backbone+FPN features across four fixed images (the root mean square of
each image's features less their mean over the images, over the root mean
square of the features: 0 when every image gives the same features), and
the ground-truth recall of the trained detector on the first six images
(a detection box at IoU > 0.3, as the examples count it). The two
trajectories are not held against each other: Adam's sign-like first steps
and the sampling's ties make them part within a few steps.

Not a test (pytest does not collect it): a measurement that needs both
frameworks, so it lives beside the tests. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_overfit_compare.py [--steps 150] [--settle] [--threads 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "examples"), os.path.dirname(os.path.abspath(__file__))]


def spread(features) -> float:
    """RMS over the images of (features - their mean over the images) over
    the RMS of the features; ``features`` is [images, ...]."""
    f = np.asarray(features, np.float64).reshape(len(features), -1)
    return float(np.sqrt(((f - f.mean(0)) ** 2).mean()) / max(np.sqrt((f ** 2).mean()), 1e-30))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--settle", action="store_true", help="settle both frameworks' starting weights")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)

    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)

    import overfit_synthetic_torch as EX
    from caesar_mrcnn_tpu.config import inference_config as jax_inference_config
    from caesar_mrcnn_tpu.data.dataset import SourceDataset as JaxDataset
    from caesar_mrcnn_tpu.data.generator import TrainingPipeline as JaxPipeline
    from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
    from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN, init_model
    from caesar_mrcnn_tpu.train.trainer import (create_train_state, make_train_step as jax_train_step,
                                                mold_batch as jax_mold_batch)
    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.config import inference_config
    from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset
    from caesar_mrcnn_tpu_torch.data.synthetic import write_survey
    from caesar_mrcnn_tpu_torch.inference.detector import Detector
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.testing import settle_flax_weights
    from caesar_mrcnn_tpu_torch.train import trainer as T
    from torch_train_fixtures import jax_config

    cfg = EX.small_config(128, 4, learning_rate=1e-3)  # the JAX example's rate
    seed = 0
    jcfg = jax_config(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        listing = write_survey(tmp, 16, seed=seed, size=128)
        jds, ds = JaxDataset(), SourceDataset()
        for d in (jds, ds):
            d.set_class_dict(EX.CLASSES)
            assert d.load_data_from_json_list(listing) == 0
            d.prepare()

        _, variables = init_model(jcfg, jax.random.PRNGKey(seed))
        variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
        if args.settle:
            variables = settle_flax_weights(variables)
        jmodel = JaxMaskRCNN(jcfg)
        state, tx = create_train_state(jcfg, jax.tree_util.tree_map(np.copy, variables))
        pipe = JaxPipeline(jds, jcfg, seed=seed, augmentation=False)
        jstep = jax_train_step(jmodel, tx, pipe.anchors_normalized())
        model = MaskRCNN(cfg)
        model.load_state_dict(W.flax_to_state_dict(variables))
        step = T.make_train_step(model, T.make_optimizer(cfg, model), pipe.anchors_normalized())
        gen = torch.Generator().manual_seed(seed + 1)

        probe = next(JaxPipeline(jds, jcfg, seed=seed + 99, augmentation=False).batches())
        jimages = jax_mold_batch(probe, jcfg)["images"]
        timages = T.mold_batch(T.batch_to_device(probe, "cpu"), cfg)["images"]

        def spreads():
            jv = {"params": state.params, **({"batch_stats": state.batch_stats} if state.batch_stats else {})}
            jf = jmodel.apply(jv, jimages, method=JaxMaskRCNN.features)
            with torch.no_grad():
                tf = model.features(timages)
            return (sum(spread(np.asarray(f)) for f in jf[:4]) / 4,
                    sum(spread(f.float().numpy()) for f in tf[:4]) / 4)

        s0 = spreads()
        print(f"start: feature spread jax {s0[0]:.4f}, port {s0[1]:.4f} (lr {cfg.learning_rate}, settled "
              f"{args.settle})")
        rng = jax.random.PRNGKey(seed + 1)
        batches = pipe.batches()
        t0 = time.time()
        for i in range(args.steps):
            rng, sub = jax.random.split(rng)
            batch = next(batches)
            state, jl = jstep(state, batch, sub)
            tl = step(T.batch_to_device(batch, "cpu"), generator=gen)
            if i == 0 or (i + 1) % 25 == 0:
                s = spreads()
                print(f"step {i + 1}: total_loss jax {float(jl['total_loss']):.4f}, port "
                      f"{float(tl['total_loss']):.4f}; feature spread jax {s[0]:.4f}, port {s[1]:.4f} "
                      f"({time.time() - t0:.0f} s)", flush=True)

        icfg = jax_inference_config(jcfg)
        jdet = JaxDetector(icfg, *init_model(icfg, jax.random.PRNGKey(0)))
        jdet.variables = {"params": jax.device_get(state.params)}
        if state.batch_stats:
            jdet.variables["batch_stats"] = jax.device_get(state.batch_stats)
        det = Detector(inference_config(cfg), model, "cpu")
        jrec = EX.gt_recall(jdet, jds, range(6))
        trec = EX.gt_recall(det, ds, range(6))
        print(f"GT recall after {args.steps} steps (IoU > 0.3, images 0-5): jax {jrec[0]}/{jrec[1]}, port "
              f"{trec[0]}/{trec[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
