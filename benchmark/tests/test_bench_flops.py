"""The FLOP count of ``benchmark/flops.py``: the ResNets against their
published multiply-adds at 224^2 (He et al. 2016, Table 1: 3.8 x 10^9 and
7.6 x 10^9; the count here leaves out the final dense layer, 2 x 10^6),
the FPN and heads against a count by hand."""

import pytest

from benchmark import flops as FL

DETECT = dict(image_max_dim=512, image_channel_count=3, backbone="resnet101", backbone_strides=[4, 8, 16, 32, 64],
              top_down_pyramid_size=256, rpn_anchor_ratios=[0.5, 1.0, 2.0], fpn_classif_fc_layers_size=1024,
              num_classes=4, pool_size=7, mask_pool_size=14, post_nms_rois_inference=1000,
              detection_max_instances=100)


@pytest.mark.parametrize("arch,published", [("resnet50", 3.8e9), ("resnet101", 7.6e9)])
def test_resnet_multiply_adds_at_224(arch, published):
    assert sum(FL.backbone_macs(arch, 224, 224).values()) == pytest.approx(published, rel=0.02)


def test_fpn_and_heads_by_hand():
    m = FL.detect_macs(DETECT)
    # laterals from C2..C5 (256, 512, 1024, 2048 channels) and the 3x3 outputs, at 128, 64, 32, 16
    sides = (128, 64, 32, 16)
    fpn = sum(s * s * 256 * c for s, c in zip(sides, (256, 512, 1024, 2048))) + sum(s * s * 256 * 256 * 9
                                                                                  for s in sides)
    assert m["fpn"] == fpn
    # the shared 3x3 to 512 and the 1x1 heads (6 + 12 outputs) on P2..P6
    assert m["rpn"] == sum(s * s * (256 * 512 * 9 + 512 * 18) for s in sides + (8,))
    # 1000 ROIs: 7x7x256 -> 1024, 1024 -> 1024, 1024 -> 4 logits and 16 deltas
    assert m["box_head"] == 1000 * (7 * 7 * 256 * 1024 + 1024 * 1024 + 1024 * 20)
    # 100 detections: four 3x3 convs at 14^2, the 2x2 stride-2 deconv, the 1x1 to 4 classes at 28^2
    assert m["mask_head"] == 100 * (4 * 14 * 14 * 256 * 256 * 9 + 14 * 14 * 256 * 256 * 4 + 28 * 28 * 256 * 4)


def test_detect_tile_is_about_291_gflop():
    assert FL.detect_flops_per_image(DETECT) == pytest.approx(291.4e9, rel=1e-3)
