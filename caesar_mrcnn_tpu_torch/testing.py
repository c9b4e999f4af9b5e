"""Comparison of two detectors' per-image results that allows for near ties,
of two source catalogs, the weights that make detectors comparable, the
kernel operators' ``opcheck`` cases (:func:`op_cases`) and the masks'
paste's seeded inputs (:func:`paste_inputs`).

Random weights make near-tied detection scores common, and two detectors
whose arithmetic differs in the last bits (JAX against PyTorch, or the card
against the CPU) may order such detections differently, or swap which of
two near-tied boxes survives NMS. So only *isolated* detections are
compared: those whose score is more than ``gap`` away from every other
score of the same image. Each isolated detection of the reference is
paired with the detection of the other result whose score is nearest;
a pair further apart than ``gap / 2`` counts as unmatched.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def settle_flax_weights(variables: Dict) -> Dict:
    """Seeded random flax weights, changed so that a detector produces
    detections to compare (in place on a numpy variable tree).

    On raw 0..255 pixels random weights saturate every softmax: all RPN
    scores tie at 1.0 and every ROI is background. Scaling the stem kernel
    by 1/255 puts the input in [0, 1], and a -1 background logit bias lets
    foreground classes win.
    """
    params = variables["params"]
    stem = params["backbone"]["conv1"]
    stem["kernel"] = np.asarray(stem["kernel"]) / 255.0
    logits = params["classifier_head"]["mrcnn_class_logits"]
    bias = np.array(logits["bias"], np.float32)
    bias[0] = -1.0
    logits["bias"] = bias
    return variables


def isolated(scores: np.ndarray, gap: float) -> np.ndarray:
    """Bool mask of scores more than ``gap`` from every other score."""
    s = np.asarray(scores, np.float64)
    if s.size < 2:
        return np.ones(s.shape, bool)
    d = np.abs(s[:, None] - s[None, :])
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1) > gap


def pair_detections(
    ref_scores: np.ndarray, got_scores: np.ndarray, gap: float = 1e-4
) -> List[Tuple[int, int]]:
    """(i, j) for every isolated detection i of ``ref``; j is the detection
    of ``got`` with the nearest score, or -1 if none lies within gap / 2."""
    ref = np.asarray(ref_scores, np.float64)
    got = np.asarray(got_scores, np.float64)
    pairs = []
    for i in np.flatnonzero(isolated(ref, gap)):
        j = int(np.argmin(np.abs(got - ref[i]))) if got.size else -1
        if j >= 0 and abs(got[j] - ref[i]) > gap / 2:
            j = -1
        pairs.append((int(i), j))
    return pairs


def compare_detections(ref: Dict, got: Dict, gap: float = 1e-4) -> Dict:
    """Compare two results of one image over their isolated detections.

    ``ref`` and ``got`` hold ``scores`` and ``class_ids`` and any of
    ``boxes`` ([n, 4], normalized), ``rois`` ([n, 4], pixels) and
    ``masks`` ([H, W, n]). Returns ``compared`` (pairs found),
    ``unmatched`` (isolated reference detections without a partner),
    ``class_mismatch``, ``mask_pixels_differ`` and the largest absolute
    difference of ``scores``, ``boxes`` and ``rois`` over the pairs.
    """
    pairs = pair_detections(ref["scores"], got["scores"], gap)
    found = [(i, j) for i, j in pairs if j >= 0]
    ii = np.array([i for i, _ in found], int)
    jj = np.array([j for _, j in found], int)
    out = {
        "compared": len(found),
        "unmatched": len(pairs) - len(found),
        "class_mismatch": int(
            (np.asarray(ref["class_ids"])[ii] != np.asarray(got["class_ids"])[jj]).sum()
        ),
    }
    for key in ("scores", "boxes", "rois"):
        if key in ref:
            a = np.asarray(ref[key], np.float64)[ii]
            b = np.asarray(got[key], np.float64)[jj]
            out[f"max_{key}_diff"] = float(np.abs(a - b).max()) if len(found) else 0.0
    if "masks" in ref:
        a = np.asarray(ref["masks"])[..., ii]
        b = np.asarray(got["masks"])[..., jj]
        out["mask_pixels_differ"] = int((a != b).sum())
    return out


def pin_heads(model) -> None:
    """Pin the detection heads of a ``MaskRCNN`` (in place): the class-logit
    and box-delta kernels zeroed, the box biases 0, the class biases 0 but
    class 2's 6, the mask kernel zeroed and its biases 3 (the JAX package's
    dryrun recipe, ``__graft_entry__.py:224-246``). Every ROI is then class
    2 at one score, its box the proposal's and its mask the whole box, so
    that two detectors' catalogs do not hang on float jitter at a score or
    mask threshold."""
    ch, mask = model.classifier_head, model.mask_head.mrcnn_mask
    with torch.no_grad():
        for layer in (ch.mrcnn_class_logits, ch.mrcnn_bbox_fc, mask):
            layer.weight.zero_()
            layer.bias.zero_()
        ch.mrcnn_class_logits.bias[2] = 6.0
        mask.bias.fill_(3.0)


def catalog_differences(ref: Dict, got: Dict, rtol: float = 0.0, score_atol: float = 0.0) -> List[str]:
    """Where two source catalogs (``SFinder`` output, as read back from its
    JSON) differ, as a list of ``path: ref != got`` lines, empty when they
    agree. Every value must be equal (names, classes, boxes, pixels,
    ``vertexes``, flags, the source count), but for the floats under
    ``pars`` (within ``rtol`` relative) and each ``score`` (within
    ``score_atol``)."""
    out: List[str] = []

    def walk(a, b, path: str, in_pars: bool) -> None:
        if isinstance(a, dict) and isinstance(b, dict):
            if sorted(a) != sorted(b):
                out.append(f"{path}: keys {sorted(a)} != {sorted(b)}")
                return
            for k in a:
                walk(a[k], b[k], f"{path}.{k}", in_pars or k == "pars")
        elif isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                out.append(f"{path}: {len(a)} != {len(b)} entries")
                return
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]", in_pars)
        elif isinstance(a, float) and isinstance(b, float) and (in_pars or path.endswith(".score")):
            tol = score_atol if path.endswith(".score") else rtol * abs(a)
            if not abs(a - b) <= tol:
                out.append(f"{path}: {a!r} != {b!r}")
        elif type(a) is not type(b) or a != b:
            out.append(f"{path}: {a!r} != {b!r}")

    walk(ref, got, "catalog", False)
    return out


def op_cases(device) -> List[Tuple[str, object, tuple]]:
    """(label, operator, arguments) of every ``caesar`` operator at small
    seeded shapes on ``device``, for ``torch.library.opcheck``: NMS with
    invalid boxes, ROIAlign with levels that take a gradient, its backward,
    the crop, the quantizer plain and padding 3 channels to 16, the int8
    convolution's three epilogues (int32 sums, f32 with ReLU, int8 at the
    next site's scale), and the masks' paste into two tiles' frames (one
    with a zero-area box and a zero class id, on ``device``). Inputs are
    contiguous, as the wrappers pass them, and 16-byte aligned, as the
    kernels take them."""
    from .ops.library import ops

    rng = np.random.RandomState(0)

    def t(a, dtype=None, grad=False):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
        return x.requires_grad_() if grad else x

    y1, x1 = rng.uniform(0, 0.7, (2, 2, 6))
    h, w = rng.uniform(0.05, 0.3, (2, 2, 6))
    boxes = t(np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32))
    scores = rng.uniform(0, 1, (2, 6)).astype(np.float32)
    scores[:, 1] = -np.inf
    levels = [t(rng.randn(2, s, s, 4).astype(np.float32), grad=True) for s in (16, 8, 4, 2)]
    shapes = [s for s in (16, 8, 4, 2) for _ in range(2)]
    xq = t(rng.randint(-127, 128, (2, 6, 6, 16)).astype(np.int8))
    wq = t(rng.randint(-127, 128, (8, 3, 3, 16)).astype(np.int8))
    sw = t(rng.uniform(1e-4, 1e-3, 8).astype(np.float32))
    bias = t(rng.uniform(-1, 1, 8).astype(np.float32))
    cases = [
        ("nms", ops.nms.default, (boxes, t(scores), 4, 0.5)),
        ("roi_align", ops.roi_align.default, (levels, boxes, [64, 64], 3)),
        ("roi_align_backward", ops.roi_align_backward.default,
         (t(rng.randn(2, 6, 3, 3, 4).astype(np.float32)), boxes, shapes, [64, 64])),
        ("crop_and_resize", ops.crop_and_resize.default,
         (t(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)), boxes, t(rng.randint(0, 3, (2, 6))), [4, 5])),
        ("quantize_int8", ops.quantize_int8.default, (t(rng.randn(2, 4, 4, 16).astype(np.float32)), 0.02, None)),
        ("quantize_int8 3 -> 16 channels", ops.quantize_int8.default,
         (t(rng.randn(2, 4, 4, 3).astype(np.float32)), 0.02, 16)),
        ("conv2d_int8 int32 sums", ops.conv2d_int8.default, (xq, wq, None, None, 1, [1, 1, 1, 1], False, None)),
        ("conv2d_int8 f32", ops.conv2d_int8.default, (xq, wq, sw, bias, 2, [0, 1, 0, 1], True, None)),
        ("conv2d_int8 int8", ops.conv2d_int8.default, (xq, wq, sw, bias, 1, [1, 1, 1, 1], True, 0.05)),
    ]
    dets = np.concatenate([boxes.cpu().numpy(), rng.randint(1, 4, (2, 6, 1)), rng.uniform(0, 1, (2, 6, 1))],
                          -1).astype(np.float32)
    dets[0, 1, 2] = dets[0, 1, 0]  # zero area
    dets[1, 4:, 4] = 0  # four detections
    frames = [torch.zeros(20 * 24 * 6, dtype=torch.bool, device=device) for _ in range(2)]
    masks = t(rng.randint(0, 256, (2, 6, 28, 28)).astype(np.uint8))
    return cases + [("paste_masks", ops.paste_masks.default, (t(dets), masks, frames, [20, 24]))]


def paste_inputs(rng, b: int, d: int, shape) -> Tuple[np.ndarray, np.ndarray]:
    """b tiles of d seeded detections [b, d, 6] f32 and u8 masks [b, d, 28,
    28] on a tile of ``shape`` (H, W), for ``ops/paste.py``: boxes from a
    few pixels to the whole tile (a quarter of the sides 0.4-1 of it, so
    both of ATen's resize kernels, by out_h + out_w, are reached), some on
    the tile's edges, a few of zero area, a tile with no detection, one
    with all d, the rest padded after a random count."""
    h, w = shape
    y1, x1 = rng.uniform(0, 1, (2, b, d))
    wide = rng.uniform(0, 1, (2, b, d)) < 0.25
    side = np.where(wide, rng.uniform(0.4, 1.0, (2, b, d)), rng.uniform(0, 0.25, (2, b, d)))
    boxes = np.stack([y1, x1, y1 + side[0], x1 + side[1]], -1).clip(0, 1)
    boxes[:, ::11, 0] = boxes[:, 1::11, 1] = 0.0
    boxes[:, 2::11, 2] = boxes[:, 3::11, 3] = 1.0
    boxes[:, 4::17] = (0.0, 0.0, 1.0, 1.0)
    boxes[:, 5::13, 2] = boxes[:, 5::13, 0] - 2.0 / (h - 1)  # dropped: no pixel rows
    cls = rng.randint(1, 4, (b, d)).astype(np.float64)
    for t in range(2, b):
        cls[t, rng.randint(1, d + 1):] = 0
    cls[0, 0] = 0
    dets = np.concatenate([boxes, cls[..., None], rng.uniform(0, 1, (b, d, 1))], -1).astype(np.float32)
    masks = rng.randint(0, 256, (b, d, 28, 28)).astype(np.uint8)
    masks[:, ::3] = (masks[:, ::3] // 64) * 64 + 63  # flatter masks: long runs near one value
    return dets, masks
