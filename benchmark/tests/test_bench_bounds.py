"""The frozen yardstick (``benchmark/bounds.py``) equals the functions it
was copied from (``caesar_mrcnn_tpu_torch/kernel_bench.py``) on seeded
shapes, and holds the bf16 peak that ``mfu`` takes."""

import numpy as np
import pytest
import torch

from benchmark import bounds as B
from caesar_mrcnn_tpu_torch import kernel_bench as K


def test_peaks_are_the_data_sheets():
    assert (B.PEAK_BYTES_PER_S, B.PEAK_F32_PER_S, B.PEAK_INT8_PER_S) == (
        K.PEAK_BYTES_PER_S, K.PEAK_F32_PER_S, K.PEAK_INT8_PER_S)
    assert B.PEAK_BF16_PER_S == 989e12
    assert B.NMS_OPS_PER_PAIR == K.NMS_OPS_PER_PAIR


@pytest.mark.parametrize("image,n,pool", [(512, 1000, 7), (512, 100, 14), (256, 512, 7)])
def test_roi_align_bound_equals_kernel_bench(image, n, pool):
    rng = np.random.RandomState(image + n + pool)
    boxes = torch.from_numpy(K.roi_case(rng, 2, n))
    levels = [(image // s, image // s) for s in (4, 8, 16, 32)]
    assert B.roi_align_pixels(boxes, levels, (image, image), pool) == K.roi_align_pixels(
        boxes, levels, (image, image), pool)
    assert B.roi_align_bound(boxes, levels, (image, image), pool, 256, 2) == K.roi_align_bound(
        boxes, levels, (image, image), pool, 256, 2)


def test_backward_crop_and_nms_bounds_equal_kernel_bench():
    levels = K.TRAIN_LEVELS
    for case in K.BACKWARD_CASES:
        b, n, pool, c = case
        assert B.roi_align_backward_bound(b, levels, n, pool, c, 2) == K.roi_align_backward_bound(
            b, levels, n, pool, c, 2)
    rng = np.random.RandomState(3)
    masks = (torch.from_numpy(rng.rand(2, 64, 64, 5)) > 0.7).float()
    boxes = torch.from_numpy(K.roi_case(rng, 2, 40))
    assign = torch.from_numpy(rng.randint(0, 5, (2, 40)))
    assert B.crop_and_resize_bound(masks.shape, boxes, assign, (28, 28)) == K.crop_and_resize_bound(
        masks.shape, boxes, assign, (28, 28))
    boxes, scores = K.nms_case(rng, 2, 600, False)
    scores = torch.from_numpy(scores)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    idx, valid = order[:, :100].int(), torch.ones(2, 100, dtype=torch.bool)
    pairs = B.nms_pairs(scores, idx, valid, 100)
    assert pairs == K.nms_pairs(scores, idx, valid, 100)
    assert B.nms_bound(2, 600, 100, pairs) == K.nms_bound(2, 600, 100, pairs)
