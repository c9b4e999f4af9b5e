"""The port's kernel bench on the CPU: the data-derived counts behind the
ROIAlign forward's and crop_and_resize's bounds (level pixels and mask
sectors their taps touch) on hand-checked boxes and against plain loops,
the bounds themselves, and the split of a profile into the port's kernels
and its wrappers' ops."""

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch import kernel_bench as kb
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.ops import roi_align as R

# a 32^2 image: every box is on P2 (its side over 224 is below 2^-1.5)
SMALL = [(8, 8), (4, 4), (2, 2), (1, 1)]


def _boxes(rows):
    return torch.tensor(rows, dtype=torch.float32)


@pytest.mark.parametrize("pool,want", [(2, 16), (3, 25)])
def test_roi_align_pixels_one_box_on_one_level(pool, want):
    """(0, 0, .5, .5) on the 8x8 P2: samples at 0 and 3.5 (pool 2) tap rows
    and columns {0, 1, 3, 4}; at 0, 1.75, 3.5 (pool 3) {0, 1, 2, 3, 4}."""
    boxes = _boxes([[[0.0, 0.0, 0.5, 0.5]]])
    assert int(R.roi_levels(boxes, 32.0 * 32.0)) == 0
    assert kb.roi_align_pixels(boxes, SMALL, (32, 32), pool) == want


def test_roi_align_pixels_two_overlapping_boxes():
    """(.5, .5, 1, 1) taps rows and columns {3, 4, 7}: 9 pixels, of which
    {3, 4}^2 are the first box's too; on two images nothing is shared."""
    a, b = [0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0]
    assert kb.roi_align_pixels(_boxes([[b]]), SMALL, (32, 32), 2) == 9
    assert kb.roi_align_pixels(_boxes([[a, b]]), SMALL, (32, 32), 2) == 16 + 9 - 4
    assert kb.roi_align_pixels(_boxes([[a], [b]]), SMALL, (32, 32), 2) == 16 + 9
    assert kb.roi_align_pixels(_boxes([[a, a]]), SMALL, (32, 32), 2) == 16


def test_roi_align_pixels_box_partly_outside():
    """(-.5, 0, .5, .5): the first sample row lies at y = -3.5, outside, and
    reads nothing; the second taps rows {3, 4} of columns {0, 1, 3, 4}."""
    assert kb.roi_align_pixels(_boxes([[[-0.5, 0.0, 0.5, 0.5]]]), SMALL, (32, 32), 2) == 8
    assert kb.roi_align_pixels(_boxes([[[-2.0, -2.0, -1.0, -1.0]]]), SMALL, (32, 32), 2) == 0


def test_roi_align_pixels_counts_each_level_apart():
    """At 512^2, (0, 0, .1, .1) lies on P2 (128^2) and (0, 0, .25, .25) on P3
    (64^2): the same corner of two maps is two sets of pixels."""
    shapes = [(128, 128), (64, 64), (32, 32), (16, 16)]
    boxes = _boxes([[[0.0, 0.0, 0.1, 0.1], [0.0, 0.0, 0.25, 0.25]]])
    assert R.roi_levels(boxes, 512.0 * 512.0).tolist() == [[0, 1]]
    # P2: samples at 0 and 12.7 -> {0, 1, 12, 13}; P3: 0 and 15.75 -> {0, 1, 15, 16}
    assert kb.roi_align_pixels(boxes, shapes, (512, 512), 2) == 16 + 16


def _pixels_by_loop(boxes, shapes, image_shape, pool):
    """Plain loops over images, boxes and samples."""
    levels = R.roi_levels(boxes, float(image_shape[0] * image_shape[1]))
    seen = set()
    for b in range(boxes.shape[0]):
        for n in range(boxes.shape[1]):
            lvl = int(levels[b, n])
            h, w = shapes[lvl]
            bx = boxes[b, n]
            ys = R._sample_coords(bx[0:1], bx[2:3], torch.tensor([h - 1.0]), pool)[0].tolist()
            xs = R._sample_coords(bx[1:2], bx[3:4], torch.tensor([w - 1.0]), pool)[0].tolist()
            for y in ys:
                for x in xs:
                    if 0 <= y <= h - 1 and 0 <= x <= w - 1:
                        y0, x0 = int(np.floor(y)), int(np.floor(x))
                        for yy in (y0, min(y0 + 1, h - 1)):
                            for xx in (x0, min(x0 + 1, w - 1)):
                                seen.add((b, lvl, yy, xx))
    return len(seen)


def _seeded_boxes(seed, b, n):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(kb.roi_case(rng, b, n))


@pytest.mark.parametrize("pool", [2, 7])
def test_roi_align_pixels_equal_a_loop(pool):
    boxes = _seeded_boxes(pool, 2, 30)
    shapes = [(s, s + 3) for s in (64, 32, 16, 8)]
    assert kb.roi_align_pixels(boxes, shapes, (256, 256), pool) == _pixels_by_loop(boxes, shapes, (256, 256), pool)


def test_crop_sectors_share_sectors():
    """Masks [1, 8, 8, G], the full-image box cropped 2x2: taps at rows and
    columns {0, 1, 7}, 9 pixels. At G = 2 a 32-byte sector holds 4 pixels'
    channels: pixels (0, 0) and (0, 1) share sector 0, (1, 0) and (1, 1)
    sector 2, (7, 0) and (7, 1) sector 14, and (0, 7), (1, 7), (7, 7) have
    their own: 6 sectors, for channel 0 and channel 1 alike. At G = 300
    every tap is its own sector."""
    full = _boxes([[[0.0, 0.0, 1.0, 1.0]]])
    assert kb.crop_sectors((1, 8, 8, 2), full, torch.tensor([[0]]), (2, 2)) == 6
    two = _boxes([[[0.0, 0.0, 1.0, 1.0]] * 2])
    assert kb.crop_sectors((1, 8, 8, 2), two, torch.tensor([[0, 1]]), (2, 2)) == 6
    assert kb.crop_sectors((1, 8, 8, 300), full, torch.tensor([[0]]), (2, 2)) == 9
    assert kb.crop_sectors((1, 8, 8, 300), two, torch.tensor([[0, 1]]), (2, 2)) == 9
    assert kb.crop_sectors((1, 8, 8, 300), two, torch.tensor([[0, 100]]), (2, 2)) == 18


def test_crop_sectors_box_partly_outside():
    """(-1, 0, 1, 1) cropped 3x2: rows at -7 (outside), 0 and 7 tap {0, 1, 7};
    columns at 0 and 7 tap {0, 1, 7}."""
    box = _boxes([[[-1.0, 0.0, 1.0, 1.0]]])
    assert kb.crop_sectors((1, 8, 8, 300), box, torch.tensor([[3]]), (3, 2)) == 9


def _sectors_by_loop(mask_shape, boxes, assign, crop):
    b_, h, w, g = mask_shape
    seen = set()
    for b in range(boxes.shape[0]):
        for r in range(boxes.shape[1]):
            bx = boxes[b, r]
            ys = R._sample_coords(bx[0:1], bx[2:3], torch.tensor([h - 1.0]), crop[0])[0].tolist()
            xs = R._sample_coords(bx[1:2], bx[3:4], torch.tensor([w - 1.0]), crop[1])[0].tolist()
            for y in ys:
                for x in xs:
                    if 0 <= y <= h - 1 and 0 <= x <= w - 1:
                        y0, x0 = int(np.floor(y)), int(np.floor(x))
                        for yy in (y0, min(y0 + 1, h - 1)):
                            for xx in (x0, min(x0 + 1, w - 1)):
                                seen.add((((b * h + yy) * w + xx) * g + int(assign[b, r])) // 8)
    return len(seen)


@pytest.mark.parametrize("g", [1, 5, 300])
def test_crop_sectors_equal_a_loop(g):
    boxes = _seeded_boxes(g, 2, 12)
    assign = torch.from_numpy(np.random.RandomState(g).randint(0, g, (2, 12)))
    shape = (2, 24, 20, g)
    assert kb.crop_sectors(shape, boxes, assign, (5, 6)) == _sectors_by_loop(shape, boxes, assign, (5, 6))


def test_bounds_count_the_data():
    """One box on P2 at pool 2 with C = 256 in bf16: 16 pixels read, 4 x 256
    outputs written, the box read; bytes bound. The crop: 9 sectors, the
    box and an int64 channel read, 4 f32 outputs written."""
    ms, by = kb.roi_align_bound(_boxes([[[0.0, 0.0, 0.5, 0.5]]]), SMALL, (32, 32), 2, 256, 2)
    assert by == "bytes" and ms == pytest.approx(((16 * 256 + 4 * 256) * 2 + 16) / 3.35e12 * 1e3)
    ms, by = kb.crop_and_resize_bound((1, 8, 8, 300), _boxes([[[0.0, 0.0, 1.0, 1.0]]]),
                                      torch.tensor([[0]]), (2, 2))
    assert by == "bytes" and ms == pytest.approx((9 * 32 + 16 + 8 + 4 * 4) / 3.35e12 * 1e3)


def test_own_kernels_split_the_profile():
    """The port's kernels by name; PyTorch's, even in an anonymous
    namespace, are the wrapper's."""
    split = {
        "void (anonymous namespace)::roi_align_kernel<__nv_bfloat16, 4, 7>(...)": (0.1, 1.0),
        "void (anonymous namespace)::roi_align_backward_kernel<float, 4>(...)": (0.2, 1.0),
        "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::...>": (0.004, 3.0),
        "void at::native::(anonymous namespace)::sort_postprocess_kernel<float>(...)": (0.002, 1.0),
        "Memset (Device)": (0.001, 1.0),
    }
    own, other, launches = kb.own_kernels(split)
    assert own == pytest.approx(0.3) and other == pytest.approx(0.007) and launches == 5.0


# ------------------------------------------------------- the int8 serving graph

SERVING = dict(num_classes=4, image_min_dim=512, image_max_dim=512, images_per_device=8,
               compute_dtype="bfloat16", quant_mode="int8", pre_nms_limit=3000, post_nms_rois_inference=512)


def test_int8_sites_of_the_serving_flagship():
    """ResNet-101 at 512^2, batch 8, 512 proposals and 100 detections per
    image: 123 int8 convolutions, 2.14 T operations (2 per multiply-add):
    the mask head 0.74 T, the RPN's shared conv 0.41 T, the backbone's 3x3
    convs 0.32 T, the FPN's 3x3 convs 0.205 T, the classifier's fc1 0.11 T."""
    from caesar_mrcnn_tpu_torch.config import detector_config

    sites = kb.int8_sites(detector_config(**SERVING), 512, 100)
    groups = {}
    for s in sites:
        groups[s.name.split("/")[0]] = groups.get(s.name.split("/")[0], 0) + s.ops
    assert len(sites) == 123 and len({s.name for s in sites}) == 123
    assert sum(s.ops for s in sites) == pytest.approx(2.14e12, rel=2e-3)
    assert groups["mask"] == pytest.approx(0.74e12, rel=5e-3)
    assert groups["rpn"] == pytest.approx(0.41e12, rel=5e-3)
    assert sum(s.ops for s in sites if s.name.startswith("bb/") and s.k == 3) == pytest.approx(0.32e12, rel=5e-3)
    assert sum(s.ops for s in sites if s.name.startswith("fpn/p")) == pytest.approx(0.205e12, rel=5e-3)
    fc1 = next(s for s in sites if s.name == "cls/conv1")
    assert (fc1.m, fc1.kdim, fc1.cout, fc1.pads) == (4096, 12544, 1024, ((0, 0), (0, 0)))
    stem = sites[0]
    assert (stem.name, stem.cin, stem.k, stem.stride, stem.pads, stem.out_hw) == \
        ("bb/conv1", 3, 7, 2, ((3, 3), (3, 3)), (256, 256))
    assert [s.name for s in sites if s.name.startswith("rpn/")] == [f"rpn/shared@p{i}" for i in range(2, 7)]
    assert set(kb.CONV_INT8_SITES) <= {s.name for s in sites}
    # a ReLU ends every convolution but a backbone block's third 1x1, its shortcut and the FPN's
    no_relu = {s.name for s in sites if s.name.startswith("fpn/")
               or s.name.startswith("bb/res") and s.name.endswith(("/conv3", "/shortcut"))}
    assert len(no_relu) == 33 + 4 + 8 and all(s.relu == (s.name not in no_relu) for s in sites)


def test_int8_sites_are_the_sites_the_int8_stages_run():
    """The recorded walk lists, in order and shape, the convolutions the
    int8 stages run on a small config (custom backbone, 64^2)."""
    from caesar_mrcnn_tpu_torch.config import detector_config
    from caesar_mrcnn_tpu_torch.models import heads_int8 as Q
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.ops import quant

    cfg = detector_config(backbone="custom", image_min_dim=64, image_max_dim=64, images_per_device=2,
                          compute_dtype="float32")
    model = MaskRCNN(cfg)
    folded = Q.fold_detect(W.state_dict_to_flax(model.state_dict()), cfg)
    ran = []
    stages = Q.folded_stages(model, folded, observe=lambda site, x: ran.append((site, tuple(x.shape))))
    with torch.inference_mode():
        stages.rpn(stages.features(torch.zeros(2, 64, 64, 3)))
        stages.classifier(torch.zeros(2, 5, 7, 7, 256))
        stages.mask(torch.zeros(2, 3, 14, 14, 256))
    sites = kb.int8_sites(cfg, 5, 3)
    assert [(s.name, (s.batch, s.h, s.w, s.cin)) for s in sites] == ran
    assert all(s.pads == quant.xla_pads(quant.pad_for(s.name), s.k, s.stride, (s.h, s.w)) for s in sites)


def test_conv_int8_bound():
    """The stem is bound by its f32 output, the mask head's 3x3 by its
    operations at the int8 tensor-core rate; a site that requantizes for
    the next writes one byte per output."""
    from caesar_mrcnn_tpu_torch.config import detector_config

    sites = {s.name: s for s in kb.int8_sites(detector_config(**SERVING), 512, 100)}
    ms, by = kb.conv_int8_bound(sites["bb/conv1"])
    assert by == "bytes"
    assert ms == pytest.approx((8 * 512 * 512 * 3 + 64 * 147 + 8 * 256 * 256 * 64 * 4) / 3.35e12 * 1e3)
    ms, by = kb.conv_int8_bound(sites["mask/conv1"])
    assert by == "operations" and ms == pytest.approx(2 * 800 * 196 * 256 * 2304 / 1979e12 * 1e3)
    assert sum(kb.conv_int8_bound(s)[0] for s in sites.values()) > 2.14e12 / 1979e12 * 1e3
    # a 1x1 stride-2 conv reads a quarter of its input: res3a/conv1 takes
    # 64^2 of the 128^2 pixels, 8 * 64 * 64 * 256 int8 bytes
    res3a = sites["bb/res3a/conv1"]
    assert (res3a.h, res3a.cin, res3a.k, res3a.stride, res3a.out_hw, res3a.read_hw) == (128, 256, 1, 2, (64, 64), (64, 64))
    ms, by = kb.conv_int8_bound(res3a._replace(then=None))
    assert by == "bytes"
    assert ms == pytest.approx((8 * 64 * 64 * 256 + 128 * 256 + 8 * 64 * 64 * 128 * 4) / 3.35e12 * 1e3)
    # it requantizes for res3a/conv2: its output leaves int8, one byte each
    ms, by = kb.conv_int8_bound(res3a)
    assert res3a.then == "bb/res3a/conv2" and by == "bytes"
    assert ms == pytest.approx((8 * 64 * 64 * 256 + 128 * 256 + 8 * 64 * 64 * 128) / 3.35e12 * 1e3)
    # the stem's 7x7/2 taps cover every row and column; only the six 1x1/2
    # convs (res3a..res5a conv1 and shortcut) skip any
    assert sites["bb/conv1"].read_hw == (512, 512)
    assert sorted(s.name for s in sites.values() if s.read_hw != (s.h, s.w)) == \
        [f"bb/res{i}a/{c}" for i in (3, 4, 5) for c in ("conv1", "shortcut")]
    assert all(s.read_hw == s.out_hw for s in sites.values() if s.k == 1 and s.stride == 2)
    ms, by = kb.quantize_bound(1000, 2)
    assert by == "bytes" and ms == pytest.approx(3000 / 3.35e12 * 1e3)


def test_input_quantize_bound():
    """The quantizer in front of a site reads its input in the dtype the
    graph hands it (bf16 into the RPN's shared conv and the heads' first
    convs, f32 elsewhere) and writes int8 with the channels padded to 16:
    the stem's image leaves with 16 bytes a pixel."""
    from caesar_mrcnn_tpu_torch.config import detector_config

    sites = kb.int8_sites(detector_config(**SERVING), 512, 100)
    assert {s.name for s in sites if s.in_bytes == 2} == \
        {f"rpn/shared@p{i}" for i in range(2, 7)} | {"cls/conv1", "mask/conv1"}
    assert all(s.in_bytes == 4 for s in sites if s.in_bytes != 2)
    by_name = {s.name: s for s in sites}
    ms, by = kb.input_quantize_bound(by_name["bb/conv1"])
    assert by == "bytes" and ms == pytest.approx((8 * 512 * 512 * 3 * 4 + 8 * 512 * 512 * 16) / 3.35e12 * 1e3)
    ms, by = kb.input_quantize_bound(by_name["rpn/shared@p2"])
    assert by == "bytes" and ms == pytest.approx(8 * 128 * 128 * 256 * 3 / 3.35e12 * 1e3)
    ms, by = kb.quantize_bound(1000, 4, 2000)
    assert by == "bytes" and ms == pytest.approx(6000 / 3.35e12 * 1e3)
