"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the detect and train paths do not reach (chip_smoke.py checks
the paths' own shapes). Skipped without a card. On the card's machine, which
has no jax, run them without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch.ops import nms as N
from caesar_mrcnn_tpu_torch.ops import roi_align as R

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


def _boxes(rng, b, n):
    y1, x1 = rng.uniform(0, 0.8, (2, b, n))
    h, w = rng.uniform(0.01, 0.3, (2, b, n))
    boxes = np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1)
    return boxes.astype(np.float32)


@pytest.mark.parametrize(
    "n,max_out,thr",
    [(1, 1, 0.5), (63, 100, 0.3), (64, 64, 0.5), (65, 10, 0.7), (1000, 1000, 0.9), (3000, 300, 0.3)],
)
def test_nms_kernel_equals_plain(cuda, n, max_out, thr):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, 3, n)
    boxes[:, ::9] = 0.0
    scores = np.round(rng.uniform(0, 1, (3, n)), 2).astype(np.float32)
    scores[:, ::7] = -np.inf
    scores[2] = -np.inf  # an image with no valid box
    boxes, scores = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = N.nms_padded.launches
    idx, valid = N.nms_padded(boxes, scores, max_out, thr)
    assert N.nms_padded.launches == before + 1
    pidx, pvalid = N.nms_sorted_plain(*N.sort_boxes(boxes, scores), max_out, thr)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx.to(torch.int32)) and torch.equal(valid, pvalid)
    assert not bool(valid[2].any()) and bool((idx[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool,c", [(7, 256), (14, 64), (2, 2)])
def test_roi_align_kernel_equals_plain(cuda, dtype, pool, c):
    rng = np.random.RandomState(pool * c)
    levels = [torch.from_numpy(rng.randn(2, s, s + 3, c).astype(np.float32)).to(cuda, dtype)
              for s in (64, 32, 16, 8)]
    boxes = _boxes(rng, 2, 50)
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, 1] = [0.5, 0.0, 1.0, 1.0]
    boxes[:, -4:] = 0.0
    boxes = torch.from_numpy(boxes).to(cuda)
    before = R.roi_align.launches
    got = R.roi_align(levels, boxes, (256, 268), pool)
    assert R.roi_align.launches == before + 1
    ref = R.roi_align_plain(levels, boxes, (256, 268), pool)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 50, pool, pool, c)
    # both sum the four taps in f32 in one order and round once
    assert torch.equal(got, ref)


def test_roi_align_kernel_rejects_what_it_does_not_take(cuda):
    levels = [torch.zeros(1, s, s, 3, device=cuda) for s in (16, 8, 4, 2)]
    boxes = torch.zeros(1, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="even C"):
        R.roi_align(levels, boxes, (64, 64), 7)
    levels = [torch.zeros(1, s, s, 4, device=cuda).half() for s in (16, 8, 4, 2)]
    with pytest.raises(TypeError):
        R.roi_align(levels, boxes, (64, 64), 7)
    levels = [torch.zeros(1, 4, s, s, device=cuda).permute(0, 2, 3, 1) for s in (16, 8, 4, 2)]
    with pytest.raises(ValueError, match="contiguous"):
        R.roi_align(levels, boxes, (64, 64), 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool,c", [(7, 256), (14, 64), (2, 2)])
def test_roi_align_backward_kernel_equals_plain(cuda, dtype, pool, c):
    """Through autograd: the backward kernel's level gradients against the
    f64 plain gradient, within 1e-5 of each element's absolute-contribution
    sum (f32 atomics in any order), plus 2 bf16 ulp at bf16."""
    rng = np.random.RandomState(pool * c + 1)
    levels = [torch.from_numpy(rng.randn(2, s, s + 3, c).astype(np.float32)).to(cuda, dtype).requires_grad_(True)
              for s in (64, 32, 16, 8)]
    boxes = _boxes(rng, 2, 50)
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, -4:] = 0.0
    boxes = torch.from_numpy(boxes).to(cuda)
    grad = torch.from_numpy(rng.randn(2, 50, pool, pool, c).astype(np.float32)).to(cuda, dtype)
    before = R.roi_align_backward.launches
    R.roi_align(levels, boxes, (256, 268), pool).backward(grad)
    assert R.roi_align_backward.launches == before + 1
    shapes = [tuple(lv.shape[1:3]) for lv in levels]
    ref = R.roi_align_backward_plain(grad.double(), boxes, shapes, (256, 268))
    mag = R.roi_align_backward_plain(grad.double().abs(), boxes, shapes, (256, 268))
    torch.cuda.synchronize()
    for lv, r, m in zip(levels, ref, mag):
        assert lv.grad.dtype == dtype and lv.grad.shape == lv.shape
        tol = 1e-5 * m
        if dtype == torch.bfloat16:
            _, e = torch.frexp(r.abs().float())
            tol = tol + 2 * torch.ldexp(torch.ones_like(r), torch.where(r == 0, -125, e) - 8)
        assert bool(((lv.grad.double() - r).abs() <= tol).all())


@pytest.mark.parametrize("h,w,g,crop", [(256, 256, 300, (28, 28)), (37, 50, 1, (5, 9)), (8, 8, 3, (2, 2))])
def test_crop_and_resize_kernel_equals_plain(cuda, h, w, g, crop):
    rng = np.random.RandomState(h + g)
    masks = torch.from_numpy((rng.rand(2, h, w, g) > 0.5).astype(np.float32) * rng.rand(2, h, w, g).astype(np.float32))
    boxes = _boxes(rng, 2, 20)
    boxes[:, 0] = [-0.3, 0.2, 0.6, 1.4]
    boxes[:, -2:] = 0.0
    assign = torch.from_numpy(rng.randint(0, g, (2, 20)))
    args = (masks.to(cuda), torch.from_numpy(boxes).to(cuda), assign.to(cuda))
    before = R.crop_and_resize.launches
    got = R.crop_and_resize(*args, crop)
    assert R.crop_and_resize.launches == before + 1
    ref = R.crop_and_resize_plain(*args, crop)
    torch.cuda.synchronize()
    assert got.shape == (2, 20) + crop and torch.equal(got, ref)


def test_crop_and_resize_kernel_rejects_what_it_does_not_take(cuda):
    masks = torch.zeros(1, 8, 8, 2, device=cuda)
    boxes = torch.zeros(1, 3, 4, device=cuda)
    assign = torch.zeros(1, 3, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        R.crop_and_resize(masks.double(), boxes, assign, (4, 4))
    with pytest.raises(ValueError, match="at least 2x2"):
        R.crop_and_resize(masks, boxes, assign, (1, 4))
    with pytest.raises(ValueError, match="one device"):
        R.crop_and_resize(masks, boxes.cpu(), assign, (4, 4))
