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


def _levels(rng, dtype, c, device, b=2, offset=0):
    """Seeded NHWC P2..P5 [b, s, s + 3, C]; with ``offset``, each level is a
    contiguous view ``offset`` elements into a larger buffer."""
    out = []
    for s in (64, 32, 16, 8):
        x = torch.from_numpy(rng.randn(b, s, s + 3, c).astype(np.float32)).to(device, dtype)
        if offset:
            buf = torch.empty(x.numel() + offset, dtype=dtype, device=device)
            buf[offset:] = x.flatten()
            x = buf[offset:].view(x.shape)
        out.append(x)
    return out


def _forward_equals_plain(levels, boxes, image_shape, pool):
    before = R.roi_align.launches
    got = R.roi_align(levels, boxes, image_shape, pool)
    assert R.roi_align.launches == before + 1
    ref = R.roi_align_plain(levels, boxes, image_shape, pool)
    torch.cuda.synchronize()
    c = levels[0].shape[-1]
    assert got.dtype == levels[0].dtype and got.shape == tuple(boxes.shape[:2]) + (pool, pool, c)
    # both sum the four taps in f32 in one order and round once
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [2, 7, 9, 14])
@pytest.mark.parametrize("c", [2, 64, 66, 256])
def test_roi_align_kernel_equals_plain(cuda, dtype, pool, c):
    """Every vector width the wrapper picks (16 bytes for C = 64 and 256; 8
    or 4 for C = 2 and 66), the two pools with their own instantiation (7,
    14) and the generic one (2, 9)."""
    rng = np.random.RandomState(pool * c)
    levels = _levels(rng, dtype, c, cuda)
    boxes = _boxes(rng, 2, 50)
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, 1] = [0.5, 0.0, 1.0, 1.0]
    boxes[:, -4:] = 0.0
    _forward_equals_plain(levels, torch.from_numpy(boxes).to(cuda), (256, 268), pool)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 4), (torch.bfloat16, 2), (torch.float32, 2)])
def test_roi_align_kernel_unaligned_levels(cuda, dtype, offset):
    """Levels that start 8 bytes (or, in bf16, 4 bytes) past a 16-byte
    boundary: the wrapper narrows the lane vector to what they allow."""
    rng = np.random.RandomState(offset)
    levels = _levels(rng, dtype, 256, cuda, offset=offset)
    nbytes = offset * levels[0].element_size()
    assert all(f.data_ptr() % 16 == nbytes and f.is_contiguous() for f in levels)
    assert R._vector_bytes(levels, 256, levels[0].element_size()) == nbytes
    boxes = torch.from_numpy(_boxes(rng, 2, 40)).to(cuda)
    _forward_equals_plain(levels, boxes, (256, 268), 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_zero_and_border_boxes(cuda, dtype):
    """Zero boxes, boxes on each border, the full image, boxes beyond the
    map (their samples outside read 0) and inverted boxes."""
    rng = np.random.RandomState(5)
    levels = _levels(rng, dtype, 256, cuda)
    boxes = np.float32([[0, 0, 0, 0], [0, 0, 1, 1], [0, 0, 0.1, 0.1], [0.9, 0.9, 1, 1], [0, 0.95, 0.2, 1],
                        [0.97, 0, 1, 0.3], [-0.2, -0.1, 0.3, 0.4], [0.8, 0.7, 1.3, 1.2], [0.5, 0.5, 0.5, 0.5],
                        [0.6, 0.6, 0.2, 0.3], [1, 1, 1, 1], [0, 0.3, 1, 0.31]])
    boxes = torch.from_numpy(np.stack([boxes, boxes[::-1]])).to(cuda)
    for pool in (7, 14):
        _forward_equals_plain(levels, boxes.contiguous(), (256, 268), pool)


def _boundary_boxes(image: int):
    """Boxes (0, 0, h, w) whose areas step one f32 ulp at a time across the
    three level boundaries of the rule, log2(sqrt(hw) * sqrt(area) / 224) =
    -1.5, -0.5 and 0.5: [1, 3 x 241, 4]."""
    denom = 224.0 / image
    rows = []
    for k in (-2, -1, 0):
        side = denom * 2.0 ** (k + 0.5)
        h = np.float32(min(side, 0.9))
        w = np.float32(side * side / h)
        ws = [w]
        for sign in (1.0, -1.0):
            v = w
            for _ in range(120):
                v = np.nextafter(v, np.float32(sign * np.inf))
                ws.append(v)
        b = np.zeros((len(ws), 4), np.float32)
        b[:, 2], b[:, 3] = h, np.sort(np.float32(ws))
        rows.append(b)
    return np.concatenate(rows)[None]


@pytest.mark.parametrize("image", [256, 512])
def test_roi_align_kernel_levels_at_boundaries(cuda, image):
    """The kernels' FPN levels equal roi_levels on the card for boxes that
    straddle every level boundary one ulp at a time: with level l filled
    with l + 1, every output of a box reads its level; then the whole
    output, on random levels, equals the plain version."""
    boxes = torch.from_numpy(_boundary_boxes(image)).to(cuda)
    want = R.roi_levels(boxes, float(image * image), 4)
    assert sorted(torch.unique(want).tolist()) == [0, 1, 2, 3]
    shapes = [(image // s, image // s) for s in (4, 8, 16, 32)]
    flat = [torch.full((1, h, w, 8), float(l + 1), device=cuda) for l, (h, w) in enumerate(shapes)]
    got = R.roi_align(flat, boxes, (image, image), 2)
    inside = got[0, :, 0, 0, 0] != 0  # samples inside the map read their level
    assert bool(inside.any())
    assert torch.equal(torch.round(got[0, inside, 0, 0, 0]).to(torch.int32) - 1, want[0, inside])
    rng = np.random.RandomState(image)
    levels = [torch.from_numpy(rng.randn(1, h, w, 64).astype(np.float32)).to(cuda) for h, w in shapes]
    _forward_equals_plain(levels, boxes, (image, image), 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_at_level_boundaries(cuda, dtype):
    """The backward kernel's levels on boxes straddling every boundary: its
    gradients against the f64 plain gradient (levels by roi_levels)."""
    image = 512
    boxes = torch.from_numpy(_boundary_boxes(image)).to(cuda)
    shapes = [(image // s, image // s) for s in (4, 8, 16, 32)]
    rng = np.random.RandomState(7)
    grad = torch.from_numpy(rng.randn(1, boxes.shape[1], 7, 7, 64).astype(np.float32)).to(cuda, dtype)
    got = R.roi_align_backward(grad, boxes, shapes, (image, image))
    _assert_backward_close(got, grad, boxes, shapes, (image, image))


@pytest.mark.parametrize("case", ["max_output mid-chunk", "threshold 0", "threshold 1", "class offset",
                                  "all invalid", "one box", "n=130", "duplicates", "second phase"])
def test_nms_kernel_edge_cases(cuda, case):
    """Edges of the chunked, two-phase sweep: the output fills in the middle
    of a 64-box chunk; nothing or everything suppressed; class-offset boxes;
    no valid box; N = 1 and N not a multiple of 64; exact duplicates; and
    clusters so dense that the first 2 * max_output boxes keep fewer than
    max_output, so the walk goes on into the second phase."""
    rng = np.random.RandomState(11)
    n, max_out, thr = {"max_output mid-chunk": (300, 100, 1.0), "threshold 0": (500, 500, 0.0),
                       "threshold 1": (500, 200, 1.0), "class offset": (1000, 300, 0.3),
                       "all invalid": (130, 50, 0.5), "one box": (1, 5, 0.5), "n=130": (130, 40, 0.5),
                       "duplicates": (200, 200, 0.7), "second phase": (1000, 50, 0.5)}[case]
    boxes = _boxes(rng, 2, n)
    if case == "second phase":  # 40 clusters of near-duplicates
        boxes = boxes[:, rng.randint(0, 40, n)] + rng.uniform(-0.002, 0.002, (2, n, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    if case == "class offset":
        boxes += 2.0 * rng.randint(1, 4, (2, n, 1)).astype(np.float32)
    if case == "all invalid":
        scores[:] = -np.inf
    if case == "duplicates":
        boxes[:, 1::2] = boxes[:, ::2]
        scores = np.round(scores, 1)
    boxes, scores = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    idx, valid = N.nms_padded(boxes, scores, max_out, thr)
    pidx, pvalid = N.nms_sorted_plain(*N.sort_boxes(boxes, scores), max_out, thr)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx.to(torch.int32)) and torch.equal(valid, pvalid)
    kept = valid.sum(1)
    if case in ("max_output mid-chunk", "threshold 1"):
        assert bool((kept == max_out).all())
    if case == "second phase":  # more than the first 100 boxes' clusters, fewer than 50 in all
        assert bool((kept > 0).all()) and bool((kept < max_out).all())
    if case == "all invalid":
        assert not bool(valid.any()) and not bool(idx.any())


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
    odd = [torch.zeros(1 * s * s * 4 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, s, s, 4)
           for s in (16, 8, 4, 2)]  # 2 bytes past a 4-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        R.roi_align(odd, boxes, (64, 64), 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool,c", [(7, 256), (14, 64), (2, 2), (5, 66)])
def test_roi_align_backward_kernel_equals_plain(cuda, dtype, pool, c):
    """Through autograd: the backward kernel's level gradients against the
    f64 plain gradient, within 1e-5 of each element's absolute-contribution
    sum (f32 atomics in any order), plus 2 bf16 ulp at bf16. C = 2 and 66
    run the kernel on channel pairs, the others on quads."""
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
    _assert_backward_close([lv.grad for lv in levels], grad, boxes, [tuple(lv.shape[1:3]) for lv in levels],
                           (256, 268))


def _assert_backward_close(got, grad, boxes, shapes, image_shape):
    """Level gradients against the f64 plain gradient: within 1e-5 of each
    element's absolute-contribution sum (f32 atomics in any order), plus 2
    bf16 ulp at bf16."""
    ref = R.roi_align_backward_plain(grad.double(), boxes, shapes, image_shape)
    mag = R.roi_align_backward_plain(grad.double().abs(), boxes, shapes, image_shape)
    torch.cuda.synchronize()
    for g, r, m, (h, w) in zip(got, ref, mag, shapes):
        assert g.dtype == grad.dtype and g.shape == (grad.shape[0], h, w, grad.shape[-1])
        tol = 1e-5 * m
        if grad.dtype == torch.bfloat16:
            _, e = torch.frexp(r.abs().float())
            tol = tol + 2 * torch.ldexp(torch.ones_like(r), torch.where(r == 0, -125, e) - 8)
        assert bool(((g.double() - r).abs() <= tol).all()), float((g.double() - r).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["contention", "direct", "no boxes"])
def test_roi_align_backward_kernel_edge_cases(cuda, dtype, case):
    """64 identical small boxes on P2, all adding to the same few pixels
    (the separable merge, contended in device memory); one full-image box at
    pool 14 whose footprint is taller and wider than 2 * pool (the direct
    path); and no boxes at all (zero gradients, no launch)."""
    rng = np.random.RandomState(3)
    shapes = [(s, s + 3) for s in (64, 32, 16, 8)]
    image_shape, pool, c = (256, 268), 7, 256
    if case == "contention":
        boxes = np.tile(np.float32([0.40, 0.42, 0.45, 0.47]), (2, 64, 1))
    elif case == "direct":
        boxes, pool, image_shape = np.float32([[[0.0, 0.0, 1.0, 1.0]]] * 2), 14, (64, 64)
    else:
        boxes = np.zeros((2, 0, 4), np.float32)
    boxes = torch.from_numpy(boxes).to(cuda)
    levels = R.roi_levels(boxes, float(image_shape[0] * image_shape[1]), 4)
    if case == "contention":
        assert bool((levels == 0).all())
    if case == "direct":
        assert bool((levels == 0).all())  # P2, 64 x 67 pixels: beyond 2 * pool
    grad = torch.from_numpy(rng.randn(2, boxes.shape[1], pool, pool, c).astype(np.float32)).to(cuda, dtype)
    before = R.roi_align_backward.launches
    got = R.roi_align_backward(grad, boxes, shapes, image_shape)
    assert R.roi_align_backward.launches == before + (case != "no boxes")
    _assert_backward_close(got, grad, boxes, shapes, image_shape)
    if case == "no boxes":
        assert all(not bool(g.any()) for g in got)


def test_roi_align_backward_kernel_rejects_what_it_does_not_take(cuda):
    boxes = torch.zeros(1, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="even C"):
        R.roi_align_backward(torch.zeros(1, 3, 7, 7, 5, device=cuda), boxes, [(16, 16)] * 4, (64, 64))
    with pytest.raises(TypeError):
        R.roi_align_backward(torch.zeros(1, 3, 7, 7, 8, device=cuda).half(), boxes, [(16, 16)] * 4, (64, 64))


@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("h,w,g,crop", [(256, 256, 300, (28, 28)), (37, 50, 1, (5, 9)), (8, 8, 3, (2, 2)),
                                        (64, 40, 2, (40, 33))])
def test_crop_and_resize_kernel_equals_plain(cuda, index, h, w, g, crop):
    """Boxes of every size, a full-image ROI (up to 2 ph x 2 pw distinct
    taps), one partly outside the map, zero boxes, an inverted box; G = 1
    and 300; the assignment as int32 or int64, read without a cast."""
    rng = np.random.RandomState(h + g)
    masks = torch.from_numpy((rng.rand(2, h, w, g) > 0.5).astype(np.float32) * rng.rand(2, h, w, g).astype(np.float32))
    boxes = _boxes(rng, 2, 20)
    boxes[:, 0] = [-0.3, 0.2, 0.6, 1.4]
    boxes[:, 1] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, 2] = [0.7, 0.6, 0.3, 0.1]
    boxes[:, -2:] = 0.0
    assign = torch.from_numpy(rng.randint(0, g, (2, 20))).to(index)
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
    with pytest.raises(TypeError, match="int32 or int64"):
        R.crop_and_resize(masks, boxes, assign.to(torch.int16), (4, 4))
