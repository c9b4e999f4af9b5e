"""The float32 reference (``benchmark/reference/mrcnn.py``) beside the
port (``caesar_mrcnn_tpu_torch``) on the CPU at small sizes, on the same
weights and inputs: layer by layer, then through a whole detect run of the
harness, judged by ``reference/judge_detect.py``."""

import numpy as np
import pytest
import torch

from benchmark.drivers.detect_tiles import build_detector
from benchmark.reference import mrcnn as M
from benchmark.weights import make_weights
from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

from conftest import small_cell


def _model(arch, side=64):
    cfg = small_cell("float32", image_min_dim=side, image_max_dim=side)[0]["config"]
    if arch == "resnet101":
        cfg.update(backbone="resnet101", top_down_pyramid_size=256, fpn_classif_fc_layers_size=1024)
    sd = make_weights(cfg, 3, "cpu")
    return cfg, sd, build_detector(cfg, sd, "cpu")


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("arch", ["custom", "resnet101"])
def test_features_rpn_and_heads_equal_the_port(arch):
    cfg, sd, det = _model(arch)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(2, 64, 64, generator=g) * 255).round()[..., None].expand(-1, -1, -1, 3).contiguous()
    with torch.no_grad():
        ours, theirs = M.features(sd, cfg, x), det.model.features(x)
        for a, b in zip(theirs, ours):
            assert _rel(a, b) < 1e-5
        _, p_ours, d_ours = M.rpn(sd, ours)
        _, p_theirs, d_theirs = det.model.rpn(theirs)
        assert float((p_ours - p_theirs).abs().max()) < 1e-5 and _rel(d_theirs, d_ours) < 1e-5
        boxes = torch.tensor([[[0.1, 0.1, 0.4, 0.5], [0.0, 0.6, 0.3, 1.0], [0.5, 0.5, 1.0, 1.0]]] * 2)
        pooled = M.roi_align(ours[:4], boxes, (64, 64), 7)
        probs, deltas = M.classifier(sd, pooled)
        _, p2, d2 = det.model.classifier(pooled)
        assert float((probs - p2).abs().max()) < 1e-5 and _rel(d2, deltas) < 1e-5
        pooled = M.roi_align(ours[:4], boxes, (64, 64), 14)
        masks = M.mask_head(sd, pooled)
        assert float((masks.permute(0, 1, 3, 4, 2) - det.model.mask(pooled)).abs().max()) < 1e-5


def test_roi_align_equals_the_ports_plain_version_at_the_edges():
    g = torch.Generator().manual_seed(2)
    levels = [torch.randn(2, s, s, 8, generator=g) for s in (32, 16, 8, 4)]  # NHWC
    y1, x1 = torch.rand(2, 60, generator=g) * 0.8, torch.rand(2, 60, generator=g) * 0.8
    size = torch.rand(2, 60, generator=g) * 0.6 + 0.02
    boxes = torch.stack([y1, x1, (y1 + size).clamp(max=1.0), (x1 + size).clamp(max=1.0)], -1)
    boxes[:, :5, 2:] = 1.0  # clipped to the tile's far edges
    boxes[:, 5:10, :2] = 0.0
    for pool in (7, 14):
        ours = M.roi_align([f.permute(0, 3, 1, 2) for f in levels], boxes, (128, 128), pool)
        # sample positions agree to the rounding of the interpolation steps
        assert float((ours - roi_align(levels, boxes, (128, 128), pool)).abs().max()) < 5e-5


def test_anchors_equal_the_ports():
    cfg = small_cell()[0]["config"]
    cfg_port = build_detector(cfg, make_weights(cfg, 0, "cpu"), "cpu").config
    assert np.allclose(M.anchors(cfg, (64, 64)), get_anchors(cfg_port, (64, 64, 3)), atol=1e-7)


def test_a_float32_run_is_judged_equal(run_small):
    res = run_small(compute_dtype="float32")
    assert res["correct"] and res["failed"] == 0
    compared = {k: v["value"] for k, v in res["compared"].items()}
    assert compared["mask_far_share"] == 0.0 and compared["det_box_gap"] < 1e-3
    assert set(res["metrics"]) == {"detect_tiles_per_s", "detect_batch_p95_ms", "device_peak_gib", "setup_s"}


def test_a_traced_run_reads_its_host_spans(run_small):
    res = run_small(trace=True)
    assert res["correct"]
    assert {"detect.enqueue_ms", "detect.unmold_ms", "detect.mfu"} <= set(res["metrics"])
    assert list(res)[-1] == "compared" and "breakdown" in res
