"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the detect and train paths do not reach (chip_smoke.py checks
the paths' own shapes). Skipped without a card. On the card's machine, which
has no jax, run them without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import os
import sys
import tempfile
import weakref

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch.ops import fold as Fo
from caesar_mrcnn_tpu_torch.ops import nms as N
from caesar_mrcnn_tpu_torch.ops import paste as P
from caesar_mrcnn_tpu_torch.ops import quant as Q
from caesar_mrcnn_tpu_torch.ops import roi_align as R
from caesar_mrcnn_tpu_torch.testing import op_cases, paste_inputs

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


# ------------------------------------------------------------------- int8


@pytest.mark.parametrize(
    "b,h,w,cin,cout,k,stride,padding",
    [(2, 37, 30, 3, 64, 7, 2, Q.STEM_PADS), (1, 9, 9, 5, 20, 3, 1, "SAME"), (2, 16, 16, 16, 8, 1, 1, "SAME"),
     (2, 15, 13, 48, 136, 3, 2, "SAME"), (3, 20, 20, 64, 200, 1, 2, "SAME"), (130, 7, 7, 32, 24, 7, 1, "VALID"),
     (1, 5, 5, 80, 1, 3, 1, "SAME")],
)
def test_conv2d_int8_kernel_equals_plain(cuda, b, h, w, cin, cout, k, stride, padding):
    """The int32 sums equal and the f32 epilogue bit-equal, with and without
    ReLU, at odd sizes: Cin not a multiple of 16 (padded by
    ``hopper_operands``), K and M tails, Cout below and across a 128 tile,
    a single filter."""
    gen = torch.Generator(device=cuda).manual_seed(h * w + cin)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=cuda, dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, device=cuda, dtype=torch.int8)
    sw = torch.rand(cout, generator=gen, device=cuda) * 1e-3
    bias = torch.rand(cout, generator=gen, device=cuda) - 0.5
    pads = Q.xla_pads(padding, k, stride, (h, w))
    before = Q.conv2d_int8.launches
    acc = Q.conv2d_int8_accumulate(x, wt, stride, pads)
    assert torch.equal(acc, Q.conv2d_int8_accumulate_plain(x, wt, stride, pads))
    for relu in (False, True):
        got = Q.conv2d_int8(x, wt, sw, bias, stride, pads, relu)
        ref = Q.conv2d_int8_plain(x, wt, sw, bias, stride, pads, relu)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.equal(got, ref)
    assert Q.conv2d_int8.launches == before + 3


def test_conv2d_int8_kernel_takes_an_unaligned_input(cuda):
    """An input view 1 byte into its buffer: copied to aligned storage by
    ``hopper_operands``."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    buf = torch.randint(-127, 128, (1 + 2 * 9 * 9 * 32,), generator=gen, device=cuda, dtype=torch.int8)
    x = buf[1:].view(2, 9, 9, 32)
    wt = torch.randint(-127, 128, (16, 3, 3, 32), generator=gen, device=cuda, dtype=torch.int8)
    pads = Q.xla_pads("SAME", 3, 1, (9, 9))
    assert x.data_ptr() % 16 and torch.equal(Q.conv2d_int8_accumulate(x, wt, 1, pads),
                                             Q.conv2d_int8_accumulate_plain(x, wt, 1, pads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (15, 0), (16, 0), (17, 0), (1000, 1), (4099, 3)])
def test_quantize_int8_kernel_equals_plain(cuda, dtype, n, offset):
    """Bit-equal on .5 ties, past +-127, at tails of the 16-byte vectors and
    on inputs that are not 16-byte aligned."""
    rng = np.random.RandomState(n)
    vals = np.concatenate([(rng.randint(-140, 140, n) + 0.5) * 0.25, rng.uniform(-40, 40, n)]).astype(np.float32)
    buf = torch.from_numpy(vals).to(cuda, dtype)
    for x, s in ((buf[offset:offset + n], 0.25), (buf[n:n + n - offset], 0.0371)):
        before = Q.quantize_int8.launches
        got = Q.quantize_int8(x, s)
        assert Q.quantize_int8.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, Q.quantize_int8_plain(x, s))


def _int8_case(cuda, b, h, w, cin, cout, k, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=cuda, dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, device=cuda, dtype=torch.int8)
    sw = torch.rand(cout, generator=gen, device=cuda) * 1e-3
    bias = torch.rand(cout, generator=gen, device=cuda) - 0.5
    return x, wt, sw, bias


def _hopper_equals_plain(x, wt, sw, bias, stride, pads):
    """The Hopper route's int32 sums equal and its f32 (with and without
    ReLU) and requantized outputs bit-equal to the plain versions."""
    routes = dict(Q.conv2d_int8.route_launches)
    acc = Q.conv2d_int8_accumulate(x, wt, stride, pads)
    assert torch.equal(acc, Q.conv2d_int8_accumulate_plain(x, wt, stride, pads))
    for relu in (False, True):
        got = Q.conv2d_int8(x, wt, sw, bias, stride, pads, relu)
        assert torch.equal(got, Q.conv2d_int8_plain(x, wt, sw, bias, stride, pads, relu))
    got = Q.conv2d_int8(x, wt, sw, bias, stride, pads, True, s_next=0.0137)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8
    assert torch.equal(got, Q.conv2d_int8_plain(x, wt, sw, bias, stride, pads, True, s_next=0.0137))
    assert Q.conv2d_int8.route_launches == {"wgmma": routes["wgmma"] + 4}


# M, K and Cout tails around 64, 128 and 256: M 126 / 72 / 396 / 128 / 130,
# K 288 / 576 / 400 / 128 / 1568 (a stage is 128 bytes), Cout 72 / 136 / 200
# / 264 / 24
HOPPER_SHAPES = [(2, 9, 7, 32, 72, 3, 1, "SAME"), (1, 17, 16, 64, 136, 3, 2, "SAME"),
                 (3, 12, 11, 16, 200, 5, 1, "SAME"), (2, 8, 8, 128, 264, 1, 1, "SAME"),
                 (130, 7, 7, 32, 24, 7, 1, "VALID")]


@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("shape", HOPPER_SHAPES, ids=[f"M{s[0]}x{s[1]}x{s[2]}-Cin{s[3]}-Cout{s[4]}-k{s[5]}"
                                                       for s in HOPPER_SHAPES])
def test_conv2d_int8_hopper_route_equals_plain(cuda, monkeypatch, bn, shape):
    """Each tile width, unsplit and split in two, at M, K and Cout tails."""
    b, h, w, cin, cout, k, stride, padding = shape
    x, wt, sw, bias = _int8_case(cuda, b, h, w, cin, cout, k, seed=bn + cin)
    pads = Q.xla_pads(padding, k, stride, (h, w))
    for splits in (1, 2):
        monkeypatch.setattr(Q, "_tiles", lambda m, n, kd, sms, bn=bn, splits=splits: (bn, splits))
        _hopper_equals_plain(x, wt, sw, bias, stride, pads)


@pytest.mark.parametrize("splits", range(1, 9))
def test_conv2d_int8_hopper_split_k(cuda, monkeypatch, splits):
    """K = 7168 (56 stages) split 1 to 8 ways, each share whole: the sums,
    and so every output, do not depend on the split."""
    x, wt, sw, bias = _int8_case(cuda, 2, 9, 9, 448, 136, 4, seed=splits)
    pads = Q.xla_pads("SAME", 4, 1, (9, 9))
    for bn in (128, 256):
        monkeypatch.setattr(Q, "_tiles", lambda m, n, kd, sms, bn=bn: (bn, splits))
        _hopper_equals_plain(x, wt, sw, bias, 1, pads)


def test_conv2d_int8_requantize_on_ties_and_past_127(cuda):
    """The requantizing epilogue bit-equal to quantize_int8_plain of the
    plain f32 output where y / s_next lands on .5 ties (sw a power of two,
    the bias a half) and far past +-127."""
    x, wt, _, _ = _int8_case(cuda, 2, 10, 10, 32, 48, 3, seed=7)
    sw = torch.full((48,), 2.0 ** -9, device=cuda)
    bias = torch.arange(48, device=cuda, dtype=torch.float32) * 0.5 - 12.0
    pads = Q.xla_pads("SAME", 3, 1, (10, 10))
    for relu, s_next in ((False, 0.25), (True, 0.5), (False, 2.0 ** -7)):
        got = Q.conv2d_int8(x, wt, sw, bias, 1, pads, relu, s_next=s_next)
        y = Q.conv2d_int8_plain(x, wt, sw, bias, 1, pads, relu)
        torch.cuda.synchronize()
        assert torch.equal(got, Q.quantize_int8_plain(y, s_next))
        ratio = y / s_next
        assert (ratio == ratio.round() + 0.5).any() or (ratio == ratio.round() - 0.5).any()
        assert (ratio.abs() > 127).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_padded_to_16_channels_equals_unpadded(cuda, dtype):
    """The stem's image quantized with its 3 channels padded to 16 and the
    packed weights padded to match: the same int32 sums as the unpadded
    conv, on the Hopper kernel (K 784 against 147)."""
    from caesar_mrcnn_tpu_torch.models.backbone_int8 import pad_input_channels

    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.uniform(-130, 130, (2, 37, 30, 3)).astype(np.float32)).to(cuda, dtype)
    before = Q.quantize_int8.launches
    xq = Q.quantize_int8(img, 1.0, channels=16)
    assert Q.quantize_int8.launches == before + 1 and xq.shape == (2, 37, 30, 16)
    plain = Q.quantize_int8_plain(img, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(xq[..., :3], plain) and not xq[..., 3:].any()
    wt = torch.randint(-127, 128, (64, 7, 7, 3), generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda, dtype=torch.int8)
    wp = pad_input_channels(wt)
    assert wp.shape == (64, 7, 7, 16) and wp.is_contiguous()
    pads = Q.xla_pads(Q.STEM_PADS, 7, 2, (37, 30))
    routes = dict(Q.conv2d_int8.route_launches)
    got = Q.conv2d_int8_accumulate(xq, wp, 2, pads)
    assert Q.conv2d_int8.route_launches["wgmma"] == routes["wgmma"] + 1
    assert torch.equal(got, Q.conv2d_int8_accumulate_plain(plain, wt, 2, pads))


def test_conv2d_int8_every_shape_takes_the_hopper_kernel(cuda):
    """Cin 3 and an input 1 byte into its buffer, readied by
    ``hopper_operands``: the plain int32 sums, each one launch of the
    Hopper kernel."""
    x, wt, _, _ = _int8_case(cuda, 1, 6, 6, 32, 16, 3, seed=0)
    x3, w3, _, _ = _int8_case(cuda, 1, 6, 6, 3, 16, 3, seed=0)
    buf = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    unaligned = buf[1:].view(x.shape).copy_(x)
    assert unaligned.data_ptr() % 16
    pads = Q.xla_pads("SAME", 3, 1, (6, 6))
    for xi, wi in ((x3, w3), (unaligned, wt)):
        n, routes = Q.conv2d_int8.launches, dict(Q.conv2d_int8.route_launches)
        got = Q.conv2d_int8_accumulate(xi, wi, 1, pads)
        assert (Q.conv2d_int8.launches, Q.conv2d_int8.route_launches) == (n + 1, {"wgmma": routes["wgmma"] + 1})
        torch.cuda.synchronize()
        assert torch.equal(got, Q.conv2d_int8_accumulate_plain(xi, wi, 1, pads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(3, 16), (1, 16), (17, 32), (16, 48)])
def test_quantize_int8_pad_kernel_equals_plain(cuda, dtype, c_in, c_out):
    rng = np.random.RandomState(c_in)
    vals = ((rng.randint(-140, 140, (5, 7, c_in)) + 0.5) * 0.25).astype(np.float32)
    x = torch.from_numpy(vals).to(cuda, dtype)
    got = Q.quantize_int8(x, 0.25, channels=c_out)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.nn.functional.pad(Q.quantize_int8_plain(x, 0.25), (0, c_out - c_in)))


def test_int8_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8, device=cuda)
    wt = torch.zeros(8, 3, 3, 16, dtype=torch.int8, device=cuda)
    sw, bias = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        Q.conv2d_int8(x.permute(0, 2, 1, 3), wt, sw, bias, 1, ((1, 1), (1, 1)))
    with pytest.raises(TypeError, match="int8"):
        Q.conv2d_int8(x.float(), wt, sw, bias, 1, ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="float32"):
        Q.conv2d_int8(x, wt, sw.double(), bias, 1, ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="different devices"):
        Q.conv2d_int8(x, wt, sw.cpu(), bias.cpu(), 1, ((1, 1), (1, 1)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        Q.quantize_int8(x, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        Q.quantize_int8(torch.zeros(4, 4, device=cuda).t(), 0.5)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.quantize_int8(torch.zeros(4, 3, device=cuda), 0.5, channels=8)


# ------------------------------------------------------- the caesar operators

OP_CASES = [label for label, _, _ in op_cases("cpu")]
# each operator's launch counter, on its public wrapper
COUNTERS = {"nms": N.nms_padded, "roi_align": R.roi_align, "roi_align_backward": R.roi_align_backward,
            "crop_and_resize": R.crop_and_resize, "quantize_int8": Q.quantize_int8, "conv2d_int8": Q.conv2d_int8,
            "paste_masks": P.paste_masks, "fold_conv_bn": Fo.fold_conv_bn}


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck_on_the_card(cuda, case):
    """Schema, fake implementation, autograd registration and tracing under
    dynamic shapes, with the kernels as the operators' implementations."""
    (_, op, args), = [c for c in op_cases(cuda) if c[0] == case]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("case", OP_CASES)
def test_operator_counts_card_launches_only(cuda, case):
    """A call of the operator itself (``torch.ops.caesar.*``) on CUDA
    tensors launches its kernel and counts one launch; the same call on CPU
    tensors runs the plain version, counts none, and gives the card's
    result (integers bit for bit; f32 within 1e-5 relative, TF32 off).
    ``conv_bias_relu``, whose CUDA implementation is cuDNN's, counts
    nothing."""
    (_, op, args), = [c for c in op_cases(cuda) if c[0] == case]
    (_, _, cpu_args), = [c for c in op_cases("cpu") if c[0] == case]
    name = op.name().split("::")[1].split(".")[0]
    counter = None if name == "conv_bias_relu" else COUNTERS[name]

    def launches():
        return counter.launches if counter else 0

    before = launches()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = op(*args)
    assert launches() == before + (counter is not None)
    ref = op(*cpu_args)
    assert launches() == before + (counter is not None)
    torch.cuda.synchronize()
    if got is None:  # the paste returns nothing: it writes its frames
        got, ref = tuple(args[2]), tuple(cpu_args[2])
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert g.device.type == "cuda" and r.device.type == "cpu" and g.dtype == r.dtype and g.shape == r.shape
        if g.is_floating_point():  # f32 sums of two devices (the backward's atomics in any order)
            assert torch.allclose(g.detach().cpu(), r.detach(), rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(g.cpu(), r)


# ---------------------------------------------------------- the masks' paste


@pytest.mark.parametrize("seed,shape,b,d", [(s, (512, 512), 16, 100) for s in range(6)]
                         + [(6, (300, 200), 8, 100), (7, (37, 50), 4, 7)])
def test_paste_masks_kernel_equals_plain(cuda, seed, shape, b, d):
    """The kernel's frames, written into pinned host memory, against the
    plain version's (the host unmold's paste on the CPU) bit for bit: over
    the cases 10,428 detections, 9,600 of them on 512^2 tiles."""
    rng = np.random.RandomState(100 + seed)
    dets, masks = paste_inputs(rng, b, d, shape)
    size = shape[0] * shape[1] * d
    frames = [torch.empty(size, dtype=torch.bool, pin_memory=True) for _ in range(b)]
    before = P.paste_masks.launches
    P.paste_masks(torch.from_numpy(dets).to(cuda), torch.from_numpy(masks).to(cuda), frames, shape)
    assert P.paste_masks.launches == before + 1
    ref = [torch.empty(size, dtype=torch.bool) for _ in range(b)]
    P.paste_masks(torch.from_numpy(dets), torch.from_numpy(masks), ref, shape)
    torch.cuda.synchronize()
    for t in range(b):
        n = len(P.kept_boxes(dets[t], shape)[0]) * shape[0] * shape[1]
        assert torch.equal(frames[t][:n], ref[t][:n]), (seed, t)


@pytest.fixture(scope="module")
def cell():
    """The benchmark cell's detector, weights and 64 tiles
    (``detect.r101-512-bf16.tiles`` at seed 3), built as the benchmark builds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import json

    from benchmark import inputs
    from benchmark.drivers.detect_tiles import build_detector
    from benchmark.weights import make_weights

    with open(os.path.join(repo, "benchmark", "configs", "mrcnn-r101-fpn256-512-bf16.json")) as f:
        model_cfg = json.load(f)["config"]
    with open(os.path.join(repo, "benchmark", "traffic", "tiles.json")) as f:
        traffic = json.load(f)
    side, size = traffic["mosaic_side"], model_cfg["image_max_dim"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.fits")
        inputs.write_mosaic(path, n=side, seed=3, sources=traffic["sources"])
        tiles = inputs.read_tiles(path, side, size)
    det = build_detector(model_cfg, make_weights(model_cfg, 3, torch.device("cuda")), torch.device("cuda"))
    bs = det.config.batch_size
    return det, [tiles[s:s + bs] for s in range(0, len(tiles), bs)]


def test_paste_on_the_cells_tiles_equals_the_host_unmold(cell):
    """Every batch of the cell's tiles: the card's frames, viewed by
    ``unmold_fetched``, against the host unmold of the same fetched
    detections and masks, every field bit for bit."""
    det, batches = cell
    pasted = 0
    for batch in batches:
        fetched = det.fetch(det.dispatch_tiles(batch))
        got = det.unmold_fetched(fetched)
        ref = det.unmold_fetched(fetched[:5] + (None,))
        for g, r in zip(got, ref):
            for key in ("rois", "class_ids", "scores", "masks"):
                assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape, key
                assert np.array_equal(g[key], r[key]), key
            pasted += len(g["scores"])
    assert pasted == 100 * 8 * len(batches)


def test_paste_adds_no_device_memory(cell, monkeypatch):
    """``device_peak_gib`` of one ``dispatch_tiles`` + ``collect`` at the
    flagship is no higher with the card's paste than with the host's (the
    kernel not launched, the same fetched batch unmolded on the host)."""
    det, batches = cell
    paste = P.paste_masks
    peaks = {}
    for on in (False, True, False):
        monkeypatch.setattr(P, "paste_masks", paste if on else (lambda *args: None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fetched = det.fetch(det.dispatch_tiles(batches[0]))
        det.unmold_fetched(fetched if on else fetched[:5] + (None,))
        torch.cuda.synchronize()
        peaks[on] = max(peaks.get(on, 0), torch.cuda.max_memory_allocated())
    assert peaks[True] <= peaks[False], peaks


def test_dropped_handle_keeps_its_frames_until_the_event(cell):
    """A handle dropped while the card still pastes: the detector holds its
    frames until the batch's event has completed, then lets them go."""
    det, batches = cell
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # hold the stream for about a second
    handle = det.dispatch_tiles(batches[1])
    refs = [weakref.ref(f) for f in handle[5]]
    del handle
    det._release_pasted()
    assert len(refs) == 8 and all(r() is not None for r in refs)
    torch.cuda.synchronize()
    det._release_pasted()
    assert all(r() is None for r in refs)
