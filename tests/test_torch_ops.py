"""The port's plain NMS and ROIAlign (``caesar_mrcnn_tpu_torch.ops``) against
the JAX package on the same numpy inputs.

These are the plain PyTorch versions that the CUDA kernels are held to on
the card; here they run because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.ops.nms import nms_padded as jax_nms
from caesar_mrcnn_tpu.ops.roi_align import multilevel_roi_align_batched, roi_levels
from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align

torch.set_num_threads(2)


def _random_boxes(rng, n, size=1.0):
    y1 = rng.uniform(0, size * 0.8, n)
    x1 = rng.uniform(0, size * 0.8, n)
    h = rng.uniform(0.01, size * 0.4, n)
    w = rng.uniform(0.01, size * 0.4, n)
    return np.stack(
        [y1, x1, np.minimum(y1 + h, size), np.minimum(x1 + w, size)], axis=1
    ).astype(np.float32)


def _nms_case(seed, n, variant):
    rng = np.random.RandomState(seed)
    if variant == "clusters":  # near-duplicates: long suppression chains
        base = _random_boxes(rng, n // 8)
        boxes = np.concatenate(
            [base + rng.uniform(-0.004, 0.004, base.shape) for _ in range(8)]
        ).astype(np.float32)
    else:
        boxes = _random_boxes(rng, n)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if variant in ("invalid", "clusters"):
        scores[rng.rand(n) < 0.1] = -np.inf
    if variant in ("zero", "clusters"):
        boxes[rng.rand(n) < 0.1] = 0.0
    if variant in ("ties", "clusters"):
        scores = np.round(scores, 2)
    if variant == "classes":  # refinement's per-class offset
        boxes = boxes + 2.0 * rng.randint(1, 4, (n, 1)).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize(
    "n,thr,variant",
    [
        (10, 0.5, "plain"),
        (100, 0.5, "invalid"),
        (300, 0.3, "zero"),
        (777, 0.7, "ties"),
        (1500, 0.5, "plain"),
        (1600, 0.9, "clusters"),
        (600, 0.3, "classes"),
    ],
)
def test_plain_nms_equals_jax(n, thr, variant):
    """Exact idx/valid equality, two images batched in one call."""
    cases = [_nms_case(n + k, n, variant) for k in range(2)]
    max_out = min(n, 200)
    idx, valid = nms_padded(
        torch.from_numpy(np.stack([c[0] for c in cases])),
        torch.from_numpy(np.stack([c[1] for c in cases])),
        max_out, thr,
    )
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    for k, (boxes, scores) in enumerate(cases):
        ji, jv = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), max_out, thr)
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[k].numpy(), np.asarray(jv))


def _pyramid(rng, b, size, c):
    return [
        rng.randn(b, size // 2**i, size // 2**i, c).astype(np.float32) for i in range(4)
    ]


def _roi_boxes(rng, b, n):
    boxes = np.stack([_random_boxes(rng, n, 1.0) for _ in range(b)])
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]      # whole image, touches every border
    boxes[:, 1] = [0.2, 0.0, 1.0, 0.6]      # large, touches three borders
    boxes[:, 2] = [0.5, 0.5, 0.52, 0.53]    # small
    boxes[:, -3:] = 0.0                     # zero padding
    return boxes


@pytest.mark.parametrize("pool", [7, 14])
def test_plain_roi_align_equals_jax_batched(pool):
    rng = np.random.RandomState(pool)
    feats = _pyramid(rng, 2, 64, 16)
    boxes = _roi_boxes(rng, 2, 40)
    ref = np.asarray(
        multilevel_roi_align_batched([jnp.asarray(f) for f in feats], jnp.asarray(boxes), (256, 256), pool)
    )
    got = roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), (256, 256), pool)
    assert got.shape == (2, 40, pool, pool, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Run the Pallas TPU kernels in interpret mode on the CPU, as
    tests/test_roi_align_pallas.py does."""
    from jax.experimental import pallas as pl

    import caesar_mrcnn_tpu.ops.roi_align_pallas as rap

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(rap.pl, "pallas_call", patched)
    return rap


@pytest.mark.parametrize("kernel", ["multilevel_roi_align_pallas", "multilevel_roi_align_vmem"])
def test_plain_roi_align_equals_pallas_kernels(interpret_pallas, kernel):
    """Per image, on boxes where the Pallas level bump leaves the FPN area
    rule unchanged (the port keeps the exact area rule)."""
    rap = interpret_pallas
    rng = np.random.RandomState(7)
    feats = _pyramid(rng, 1, 128, 32)
    boxes = np.array(
        [
            [0.1, 0.1, 0.14, 0.15],
            [0.0, 0.0, 1.0, 1.0],
            [0.5, 0.5, 0.52, 0.53],
            [0.3, 0.4, 0.33, 0.47],
            [0.6, 0.0, 0.8, 0.25],
            [0.0, 0.0, 0.0, 0.0],
        ],
        dtype=np.float32,
    )
    shapes = np.array([f.shape[1:3] for f in feats], np.int32)
    assert (
        np.asarray(rap._assign_levels(jnp.asarray(boxes), (512, 512), shapes, rap.BLOCK_H - 2))
        == np.asarray(roi_levels(jnp.asarray(boxes), 512.0 * 512.0, 4))
    ).all()
    kw = {"boxes_per_step": 4} if kernel.endswith("vmem") else {}
    ref = np.asarray(
        getattr(rap, kernel)([jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes), (512, 512), 7, **kw)
    )
    got = roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes[None]), (512, 512), 7)
    np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-5)


def _kernel_levels(boxes, image_shape):
    """The CUDA kernels' level rule (``sampling.cuh::fpn_level``) in numpy
    f32, with the wrapper's reciprocal of the rule's denominator."""
    from caesar_mrcnn_tpu_torch.ops.roi_align import _level_inv_denom

    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    scale = np.sqrt(np.maximum(h * w, np.float32(1e-12))) * np.float32(_level_inv_denom(image_shape))
    return np.clip(np.float32(4.0) + np.rint(np.log2(scale)), 2, 5).astype(np.int32) - 2


@pytest.mark.parametrize("image", [256, 512, 1024])
def test_kernel_level_rule_equals_jax_roi_levels(image):
    """Away from the boundaries, where the last ulp of a division decides and
    the card's roi_levels rounds as the kernels do, the kernels' rule is
    JAX's roi_levels."""
    rng = np.random.RandomState(image)
    y1, x1 = rng.uniform(0, 0.9, (2, 4000))
    h, w = np.exp(rng.uniform(np.log(0.003), np.log(2.0), (2, 4000)))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)
    boxes[::50] = 0.0
    exact = np.log2(np.sqrt(np.float64(h) * w) * image / 224.0)
    away = np.abs(exact - np.floor(exact) - 0.5) > 1e-4
    away[::50] = True
    got = _kernel_levels(boxes, (image, image))
    want = np.asarray(roi_levels(jnp.asarray(boxes), float(image * image), 4))
    assert np.array_equal(got[away], want[away])
    assert set(got[away].tolist()) == {0, 1, 2, 3}


def test_kernel_vector_width_follows_c_and_alignment():
    """The forward kernel's lane vector: the widest of 16, 8 and 4 bytes
    (two channels at least) that C's bytes and every level's address allow."""
    from caesar_mrcnn_tpu_torch.ops.roi_align import _vector_bytes

    def levels(dtype, c, offset):
        buf = torch.zeros(4 * (c * 16 + offset), dtype=dtype)
        return [buf[offset + i * c * 16:][:c * 16].view(1, 4, 4, c) for i in range(4)]

    for dtype, c, offset, want in [(torch.bfloat16, 256, 0, 16), (torch.bfloat16, 256, 4, 8),
                                   (torch.bfloat16, 256, 2, 4), (torch.bfloat16, 66, 0, 4),
                                   (torch.bfloat16, 68, 0, 8), (torch.float32, 256, 0, 16),
                                   (torch.float32, 256, 2, 8), (torch.float32, 66, 0, 8)]:
        lv = levels(dtype, c, offset)
        assert lv[0].data_ptr() % 16 == offset * lv[0].element_size() % 16
        assert _vector_bytes(lv, c, lv[0].element_size()) == want, (dtype, c, offset)
    for dtype, offset in [(torch.bfloat16, 1), (torch.float32, 1)]:
        lv = levels(dtype, 256, offset)
        with pytest.raises(ValueError, match="aligned"):
            _vector_bytes(lv, 256, lv[0].element_size())
