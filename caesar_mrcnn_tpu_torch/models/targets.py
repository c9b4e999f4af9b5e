"""Training targets (port of ``caesar_mrcnn_tpu/models/targets.py``).

* :func:`build_rpn_targets`: host-side (numpy) anchor <-> GT matching with
  anchor-aligned delta targets; the same code and the same draws from the
  ``RandomState`` as the JAX package's, with its native library.
* :func:`detection_targets`: device-side ROI sampling and class, box and
  mask targets, batched over images with static shapes: fixed positive and
  negative slot counts picked by top-k over random priorities under a mask,
  and mask targets cropped by the ``crop_and_resize`` kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..config import Config
from ..ops.roi_align import crop_and_resize
from ..utils import boxes as B
from .proposals import top_k

# ------------------------------------------------------------------- host RPN


def _rand_subset(rng: np.random.RandomState, n: int, k: int) -> np.ndarray:
    """Uniform k-subset of range(n) without replacement (first k distinct
    values of an iid stream when k << n, else a permutation's prefix)."""
    if 4 * k >= n:
        return rng.permutation(n)[:k]
    out = np.empty(0, np.int64)
    while out.size < k:
        draw = rng.randint(0, n, size=2 * (k - out.size) + 16)
        if out.size:
            draw = draw[~np.isin(draw, out)]
        _, first = np.unique(draw, return_index=True)
        draw = draw[np.sort(first)]
        out = np.concatenate([out, draw[: k - out.size]])
    return out


def _subsample(rng, rpn_match: np.ndarray, value: int, budget: int) -> None:
    """Keep a uniform ``budget``-subset of ``rpn_match == value``, zeroing
    the rest in place."""
    ids = np.where(rpn_match == value)[0]
    if len(ids) > budget:
        keep = _rand_subset(rng, len(ids), budget)
        rpn_match[ids] = 0
        rpn_match[ids[keep]] = value


def build_rpn_targets(
    anchors: np.ndarray,
    gt_class_ids: np.ndarray,
    gt_boxes: np.ndarray,
    config: Config,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor-aligned RPN targets.

    Args:
      anchors: [A, 4] in pixel coordinates.
      gt_class_ids: [G] (negative = crowd).
      gt_boxes: [G, 4] pixel coordinates.

    Returns (rpn_match [A] int32: 1 positive, -1 negative, 0 neutral;
    rpn_deltas [A, 4] float32 over ``rpn_bbox_std_dev``, set where match == 1).
    """
    rng = rng or np.random
    a = anchors.shape[0]
    rpn_match = np.zeros([a], dtype=np.int32)
    rpn_deltas = np.zeros([a, 4], dtype=np.float32)

    if gt_boxes.shape[0] == 0:
        rpn_match[:] = -1
        _subsample(rng, rpn_match, -1, config.rpn_train_anchors_per_image)
        return rpn_match, rpn_deltas

    crowd_ix = np.where(gt_class_ids < 0)[0]
    no_crowd = np.ones([a], dtype=bool)
    if crowd_ix.shape[0] > 0:
        crowd_boxes = gt_boxes[crowd_ix]
        gt_boxes = gt_boxes[np.where(gt_class_ids > 0)[0]]
        stats = native.rpn_anchor_stats(anchors, crowd_boxes)
        crowd_max = stats[0] if stats is not None else native.iou_matrix(anchors, crowd_boxes).max(axis=1)
        no_crowd = crowd_max < 0.001

    if gt_boxes.shape[0] == 0:
        rpn_match[no_crowd] = -1
        return rpn_match, rpn_deltas

    stats = native.rpn_anchor_stats(anchors, gt_boxes)
    if stats is not None:
        anchor_iou_max, anchor_iou_argmax, gt_tie = stats
    else:
        ious = B.compute_overlaps(anchors, gt_boxes)
        anchor_iou_argmax = np.argmax(ious, axis=1)
        anchor_iou_max = ious[np.arange(a), anchor_iou_argmax]
        gt_max = np.max(ious, axis=0)
        gt_tie = ((ious == gt_max) & (gt_max > 0)).any(axis=1)
    # negatives, then the best anchor of each GT that overlaps any anchor
    # (ties included), then IoU >= 0.7 positives
    rpn_match[(anchor_iou_max < 0.3) & no_crowd] = -1
    rpn_match[gt_tie] = 1
    rpn_match[anchor_iou_max >= 0.7] = 1

    _subsample(rng, rpn_match, 1, config.rpn_train_anchors_per_image // 2)
    _subsample(rng, rpn_match, -1, config.rpn_train_anchors_per_image - int(np.sum(rpn_match == 1)))

    pos = np.where(rpn_match == 1)[0]
    if pos.size:
        gt = gt_boxes[anchor_iou_argmax[pos]]
        deltas = B.box_refinement_np(anchors[pos].astype(np.float32), gt.astype(np.float32))
        rpn_deltas[pos] = deltas / np.asarray(config.rpn_bbox_std_dev, np.float32)
    return rpn_match, rpn_deltas


# ------------------------------------------------------------- device targets


def sampling_width(num_proposals: int, config: Config) -> int:
    """Width of the sampling priorities: the proposal count, padded up to
    the larger slot budget as the JAX code pads (``targets.py:186-190``)."""
    pos_cap = int(config.train_rois_per_image * config.roi_positive_ratio)
    return max(num_proposals, pos_cap, config.train_rois_per_image - pos_cap)


def detection_targets(
    proposals: torch.Tensor,     # [B, P, 4] normalized, zero-padded
    gt_class_ids: torch.Tensor,  # [B, G] zero-padded; negative = crowd
    gt_boxes: torch.Tensor,      # [B, G, 4] normalized, zero-padded
    gt_masks: torch.Tensor,      # [B, mH, mW, G] float32
    config: Config,
    priorities: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
):
    """Sample ROIs and build their targets for a batch, with no per-image
    loop (JAX ``detection_targets`` under ``vmap``).

    * positives: IoU >= 0.5 with a valid GT; up to
      ``int(train_rois_per_image * roi_positive_ratio)``, sampled uniformly;
    * negatives: IoU < 0.5 and no crowd overlap, as many as keep the
      positive fraction at ``roi_positive_ratio``;
    * layout: ``train_rois_per_image`` slots = [positives | negatives],
      zero-padded.

    ``priorities`` = (pos_u, neg_u), each [B, :func:`sampling_width`]
    uniform in [0, 1), decides the sample; without it they are drawn with
    ``torch.rand(generator=generator)``.

    Returns (rois [B, R, 4], class_ids [B, R] int32, deltas [B, R, 4],
    masks [B, R, mh, mw]).
    """
    cfg = config
    r_total = cfg.train_rois_per_image
    pos_cap = int(r_total * cfg.roi_positive_ratio)
    neg_cap = r_total - pos_cap
    mh, mw = cfg.mask_shape
    b = proposals.shape[0]
    dev = proposals.device

    width = sampling_width(proposals.shape[1], cfg)
    if proposals.shape[1] < width:
        proposals = torch.cat([proposals, proposals.new_zeros(b, width - proposals.shape[1], 4)], 1)
    if priorities is None:
        priorities = tuple(torch.rand((b, width), generator=generator, device=dev) for _ in range(2))
    pos_u, neg_u = priorities
    if pos_u.shape != (b, width) or neg_u.shape != (b, width):
        raise ValueError(f"priorities must be [B={b}, {width}], got {tuple(pos_u.shape)} {tuple(neg_u.shape)}")

    prop_valid = (proposals[..., 2] - proposals[..., 0]) * (proposals[..., 3] - proposals[..., 1]) > 0
    gt_valid = gt_class_ids > 0
    crowd = gt_class_ids < 0

    ious = B.overlaps(proposals, gt_boxes)  # [B, P, G]
    zero = torch.zeros_like(ious)
    iou_gt = torch.where(gt_valid[:, None, :], ious, zero)
    no_crowd = torch.where(crowd[:, None, :], ious, zero).amax(2) < 0.001

    roi_iou_max = iou_gt.amax(2)
    positive = prop_valid & (roi_iou_max >= 0.5)
    negative = prop_valid & (roi_iou_max < 0.5) & no_crowd

    # random-priority top-k under a mask; top_k breaks ties like jax.lax.top_k
    ninf = torch.full_like(pos_u, -float("inf"))
    _, pos_idx = top_k(torch.where(positive, pos_u, ninf), pos_cap)
    pos_ok = torch.gather(positive, 1, pos_idx)
    n_pos = pos_ok.sum(1, dtype=torch.int32)
    ratio_count = ((1.0 / cfg.roi_positive_ratio) * n_pos.float()).to(torch.int32) - n_pos
    _, neg_idx = top_k(torch.where(negative, neg_u, ninf), neg_cap)
    neg_rank = torch.arange(neg_cap, device=dev)
    neg_ok = torch.gather(negative, 1, neg_idx) & (neg_rank[None, :] < ratio_count[:, None])

    def rows(t, idx):  # t [B, P, k], idx [B, n] -> [B, n, k]
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    pos_rois = torch.where(pos_ok[..., None], rows(proposals, pos_idx), 0.0)
    neg_rois = torch.where(neg_ok[..., None], rows(proposals, neg_idx), 0.0)

    gt_assign = rows(iou_gt, pos_idx).argmax(2)  # [B, pos_cap]; first max, as jnp.argmax
    roi_gt_boxes = rows(gt_boxes, gt_assign)
    roi_gt_class = torch.where(pos_ok, torch.gather(gt_class_ids, 1, gt_assign), 0).to(torch.int32)

    std = torch.tensor(cfg.bbox_std_dev, dtype=torch.float32, device=dev)
    deltas = torch.where(pos_ok[..., None], B.box_refinement(pos_rois, roi_gt_boxes) / std, 0.0)

    if cfg.use_mini_mask:
        # ROI coordinates -> normalized coordinates of the GT box's mini-mask
        gy1, gx1, gy2, gx2 = roi_gt_boxes.unbind(-1)
        gh = (gy2 - gy1).clamp_min(1e-8)
        gw = (gx2 - gx1).clamp_min(1e-8)
        crop_boxes = torch.stack([
            (pos_rois[..., 0] - gy1) / gh, (pos_rois[..., 1] - gx1) / gw,
            (pos_rois[..., 2] - gy1) / gh, (pos_rois[..., 3] - gx1) / gw,
        ], -1)
    else:
        crop_boxes = pos_rois
    masks = torch.round(crop_and_resize(gt_masks, crop_boxes.contiguous(), gt_assign, (mh, mw)))
    masks = torch.where(pos_ok[..., None, None], masks, 0.0)

    rois = torch.cat([pos_rois, neg_rois], 1)
    class_ids = torch.cat([roi_gt_class, roi_gt_class.new_zeros(b, neg_cap)], 1)
    deltas = torch.cat([deltas, deltas.new_zeros(b, neg_cap, 4)], 1)
    masks = torch.cat([masks, masks.new_zeros(b, neg_cap, mh, mw)], 1)
    return rois, class_ids, deltas, masks
