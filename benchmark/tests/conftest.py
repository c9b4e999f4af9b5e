"""A cell of the benchmark at a size that the CPU holds: the detect cell's
configuration with the repository's small test backbone at 64^2 tiles,
batch 2, small proposal budgets, on a 128^2 mosaic (2 batches)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run as R  # noqa: E402

CELL = "detect.r101-512-bf16.tiles"


def small_cell(compute_dtype="bfloat16", mosaic_side=128, **overrides):
    """(config, traffic) of :data:`CELL` at the small size; ``overrides``
    change the model's configuration."""
    config = R.load_json(os.path.join(ROOT, "benchmark", "configs", "mrcnn-r101-fpn256-512-bf16.json"))
    model = dict(config["config"], backbone="custom", top_down_pyramid_size=32, fpn_classif_fc_layers_size=64,
                 image_min_dim=64, image_max_dim=64, images_per_device=2, pre_nms_limit=300,
                 post_nms_rois_inference=60, detection_max_instances=12, compute_dtype=compute_dtype)
    model.update(overrides)
    config["config"] = model
    traffic = R.load_json(os.path.join(ROOT, "benchmark", "traffic", "tiles.json"))
    traffic.update(mosaic_side=mosaic_side, sources=12, warmup_passes=1, traced_batches=2, check_batches=2,
                   check_from=0, check_before=2)
    return config, traffic


@pytest.fixture
def run_small():
    """Run :data:`CELL` once on the CPU at the small size."""

    def run(seed=5, seconds=2.0, trace=False, compute_dtype="bfloat16", make_detector=None, mosaic_side=128,
            **overrides):
        config, traffic = small_cell(compute_dtype, mosaic_side, **overrides)
        return R.run_cell(CELL, seed, seconds, trace, device="cpu", config=config, traffic=traffic,
                          make_detector=make_detector)

    return run
