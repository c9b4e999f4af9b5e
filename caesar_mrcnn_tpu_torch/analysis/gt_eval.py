"""Per-image GT vs detection matching: confusion matrix, completeness,
reliability inputs.

Re-derivation of the reference's GT handling + performance computation
(reference: mrcnn/analyze.py:1039-1156 GT mask extraction/merge,
1682-1860 mask-IoU matching / confusion matrix).

The port's copy of ``caesar_mrcnn_tpu/analysis/gt_eval.py``, unchanged in behaviour
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.graph import Graph
from . import masks as M


def extract_gt_masks(
    gt_masks: np.ndarray,
    gt_class_ids: np.ndarray,
    merge_overlapped: bool = True,
) -> Tuple[List[np.ndarray], List[int], List[List[int]]]:
    """Merge connected same-class GT masks (reference:
    mrcnn/analyze.py:1039-1156).

    Returns (merged_masks, merged_class_ids, component_indices) where
    component_indices maps each merged mask to the original instance
    indices it absorbed.
    """
    n = gt_masks.shape[-1]
    masks = [gt_masks[:, :, i].astype(np.uint8) for i in range(n)]
    ids = [int(c) for c in gt_class_ids]
    if not merge_overlapped or n == 0:
        return masks, ids, [[i] for i in range(n)]

    g = Graph(n)
    for i in range(n):
        for j in range(i + 1, n):
            if ids[i] != ids[j]:
                continue
            if M.are_masks_connected(masks[i], masks[j]):
                g.addEdge(i, j)
    out_masks: List[np.ndarray] = []
    out_ids: List[int] = []
    out_members: List[List[int]] = []
    for comp in g.connectedComponents():
        mask = masks[comp[0]]
        for idx in comp[1:]:
            mask = M.merge_masks(mask, masks[idx])
        out_masks.append(mask)
        out_ids.append(ids[comp[0]])
        out_members.append(list(comp))
    return out_masks, out_ids, out_members


@dataclass
class ImageEval:
    """Per-image evaluation results (inputs to ModelTester aggregation,
    reference attributes: mrcnn/analyze.py:190-316)."""

    n_classes: int
    confusion_matrix: np.ndarray = None  # [C, C] true x det
    nobjs_true: np.ndarray = None        # [C]
    nobjs_det: np.ndarray = None         # [C]
    nobjs_det_right: np.ndarray = None   # [C]
    # per-GT
    is_gt_obj_detected: List[bool] = field(default_factory=list)
    detobj_classids: List[int] = field(default_factory=list)
    detobj_class_names: List[str] = field(default_factory=list)
    detobj_scores: List[float] = field(default_factory=list)
    detobj_ious: List[float] = field(default_factory=list)
    # per-det
    is_det_obj_matching_to_gt_obj: List[bool] = field(default_factory=list)
    matchobj_classids: List[int] = field(default_factory=list)
    matchobj_class_names: List[str] = field(default_factory=list)
    matchobj_ious: List[float] = field(default_factory=list)
    gt_class_ids: List[int] = field(default_factory=list)


def evaluate_image(
    gt_masks: List[np.ndarray],
    gt_class_ids: List[int],
    det_masks: List[np.ndarray],
    det_class_ids: List[int],
    det_scores: List[float],
    class_names: Sequence[str],
    iou_thr: float = 0.6,
) -> ImageEval:
    """Mask-IoU matching at ``iou_thr`` -> confusion matrix + per-object
    records (reference: mrcnn/analyze.py:1682-1860).

    Each GT is matched to the det mask of maximum IoU >= threshold
    (class-agnostic match; the class pair feeds the confusion matrix).
    """
    c = len(class_names)
    ev = ImageEval(n_classes=c)
    ev.confusion_matrix = np.zeros((c, c), dtype=np.float64)
    ev.nobjs_true = np.zeros(c, dtype=np.int64)
    ev.nobjs_det = np.zeros(c, dtype=np.int64)
    ev.nobjs_det_right = np.zeros(c, dtype=np.int64)
    ev.gt_class_ids = list(gt_class_ids)

    n_gt = len(gt_masks)
    n_det = len(det_masks)
    iou = np.zeros((n_gt, n_det), dtype=np.float64)
    for i in range(n_gt):
        for j in range(n_det):
            b1 = M.mask_bbox(gt_masks[i])
            b2 = M.mask_bbox(det_masks[j])
            if not M.bboxes_adjacent(b1, b2, gap=0):
                continue
            iou[i, j] = M.mask_iou(gt_masks[i], det_masks[j])

    # per-GT best match
    det_taken = np.full(n_det, -1, dtype=np.int64)
    for i in range(n_gt):
        cid = gt_class_ids[i]
        if 0 <= cid < c:
            ev.nobjs_true[cid] += 1
        j_best = int(np.argmax(iou[i])) if n_det else -1
        iou_best = iou[i, j_best] if n_det else 0.0
        if n_det and iou_best >= iou_thr:
            ev.is_gt_obj_detected.append(True)
            ev.detobj_classids.append(int(det_class_ids[j_best]))
            ev.detobj_class_names.append(class_names[det_class_ids[j_best]])
            ev.detobj_scores.append(float(det_scores[j_best]))
            ev.detobj_ious.append(float(iou_best))
            det_taken[j_best] = i
            ev.confusion_matrix[cid, det_class_ids[j_best]] += 1
            if det_class_ids[j_best] == cid:
                ev.nobjs_det_right[cid] += 1
        else:
            ev.is_gt_obj_detected.append(False)
            ev.detobj_classids.append(-1)
            ev.detobj_class_names.append("")
            ev.detobj_scores.append(-1.0)
            ev.detobj_ious.append(-1.0)

    # per-det match-back
    for j in range(n_det):
        cid = det_class_ids[j]
        if 0 <= cid < c:
            ev.nobjs_det[cid] += 1
        i_best = int(np.argmax(iou[:, j])) if n_gt else -1
        iou_best = iou[i_best, j] if n_gt else 0.0
        if n_gt and iou_best >= iou_thr:
            ev.is_det_obj_matching_to_gt_obj.append(True)
            ev.matchobj_classids.append(int(gt_class_ids[i_best]))
            ev.matchobj_class_names.append(class_names[gt_class_ids[i_best]])
            ev.matchobj_ious.append(float(iou_best))
        else:
            ev.is_det_obj_matching_to_gt_obj.append(False)
            ev.matchobj_classids.append(-1)
            ev.matchobj_class_names.append("")
            ev.matchobj_ious.append(-1.0)
    return ev
