"""Matterport-style mask-aware AP (the reference's built-in mAP path,
reference: mrcnn/utils.py:725-862).

The port's copy of ``caesar_mrcnn_tpu/evalmetrics/ap.py``, unchanged in behaviour
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.boxes import compute_overlaps, compute_overlaps_masks, trim_zeros


def compute_matches(
    gt_boxes, gt_class_ids, gt_masks,
    pred_boxes, pred_class_ids, pred_scores, pred_masks,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
):
    """Greedy score-ordered matching on mask IoU
    (reference: mrcnn/utils.py:725-781)."""
    gt_boxes = trim_zeros(np.asarray(gt_boxes, dtype=np.float64))
    gt_masks = gt_masks[..., : gt_boxes.shape[0]]
    pred_boxes = trim_zeros(np.asarray(pred_boxes, dtype=np.float64))
    pred_scores = pred_scores[: pred_boxes.shape[0]]
    indices = np.argsort(pred_scores)[::-1]
    pred_boxes = pred_boxes[indices]
    pred_class_ids = np.asarray(pred_class_ids)[indices]
    pred_scores = np.asarray(pred_scores)[indices]
    pred_masks = pred_masks[..., indices]

    overlaps = compute_overlaps_masks(pred_masks, gt_masks)
    pred_match = -1 * np.ones([pred_boxes.shape[0]])
    gt_match = -1 * np.ones([gt_boxes.shape[0]])
    for i in range(len(pred_boxes)):
        sorted_ixs = np.argsort(overlaps[i])[::-1]
        low = np.where(overlaps[i, sorted_ixs] < score_threshold)[0]
        if low.size > 0:
            sorted_ixs = sorted_ixs[: low[0]]
        for j in sorted_ixs:
            if gt_match[j] > -1:
                continue
            if overlaps[i, j] < iou_threshold:
                break
            if pred_class_ids[i] == gt_class_ids[j]:
                gt_match[j] = i
                pred_match[i] = j
                break
    return gt_match, pred_match, overlaps


def compute_ap(
    gt_boxes, gt_class_ids, gt_masks,
    pred_boxes, pred_class_ids, pred_scores, pred_masks,
    iou_threshold: float = 0.5,
):
    """VOC-style every-point AP on mask matches
    (reference: mrcnn/utils.py:784-822)."""
    gt_match, pred_match, overlaps = compute_matches(
        gt_boxes, gt_class_ids, gt_masks,
        pred_boxes, pred_class_ids, pred_scores, pred_masks,
        iou_threshold,
    )
    precisions = np.cumsum(pred_match > -1) / (np.arange(len(pred_match)) + 1)
    recalls = np.cumsum(pred_match > -1).astype(np.float32) / max(len(gt_match), 1)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = np.maximum(precisions[i], precisions[i + 1])
    indices = np.where(recalls[:-1] != recalls[1:])[0] + 1
    mAP = np.sum((recalls[indices] - recalls[indices - 1]) * precisions[indices])
    return mAP, precisions, recalls, overlaps


def compute_ap_range(
    gt_box, gt_class_id, gt_mask,
    pred_box, pred_class_id, pred_score, pred_mask,
    iou_thresholds: Optional[Sequence[float]] = None,
    verbose: int = 0,
):
    """Mean AP over IoU 0.5..0.95 (reference: mrcnn/utils.py:825-846)."""
    iou_thresholds = (
        np.asarray(iou_thresholds) if iou_thresholds is not None else np.arange(0.5, 1.0, 0.05)
    )
    aps = []
    for t in iou_thresholds:
        ap = compute_ap(
            gt_box, gt_class_id, gt_mask,
            pred_box, pred_class_id, pred_score, pred_mask,
            iou_threshold=t,
        )[0]
        aps.append(ap)
        if verbose:
            print(f"AP @{t:.2f}:\t {ap:.3f}")
    return float(np.mean(aps))


def compute_recall(pred_boxes, gt_boxes, iou: float):
    """Recall at IoU threshold (reference: mrcnn/utils.py:849-862)."""
    overlaps = compute_overlaps(pred_boxes, gt_boxes)
    iou_max = np.max(overlaps, axis=1)
    iou_argmax = np.argmax(overlaps, axis=1)
    positive_ids = np.where(iou_max >= iou)[0]
    matched = iou_argmax[positive_ids]
    recall = len(set(matched)) / gt_boxes.shape[0]
    return recall, positive_ids
