"""Final detection refinement: class assignment, box refinement, per-class
NMS, per-class cap, top-k; static shapes, batched (port of
``caesar_mrcnn_tpu/models/detection.py``)."""

from __future__ import annotations

import torch

from ..ops.nms import nms_padded
from ..utils.boxes import apply_box_deltas, clip_boxes
from .proposals import top_k


def refine_detections(
    rois: torch.Tensor,          # [B, R, 4] normalized, zero-padded
    probs: torch.Tensor,         # [B, R, C]
    deltas: torch.Tensor,        # [B, R, C, 4]
    windows: torch.Tensor,       # [B, 4] normalized
    bbox_std_dev: torch.Tensor,  # [4]
    num_classes: int,
    max_instances: int,
    min_confidence: float,
    nms_threshold: float,
) -> torch.Tensor:
    """Returns detections [B, max_instances, 6] = (y1, x1, y2, x2, class,
    score), zero-padded (class 0 marks padding)."""
    b, r = rois.shape[:2]
    neg_inf = torch.full_like(probs[..., 0], float("-inf"))
    class_ids = torch.argmax(probs, dim=2)
    class_scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    specific = torch.gather(deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    refined = apply_box_deltas(rois, specific * bbox_std_dev)
    refined = clip_boxes(refined, windows[:, None, :])

    roi_valid = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1]) > 0
    keep = roi_valid & (class_ids > 0)
    if min_confidence:
        keep &= class_scores >= min_confidence

    # Per-class NMS in one call: shifting each class's boxes by class_id * 2
    # makes cross-class IoU exactly 0 (boxes live in [0, 1]).
    boxes_for_nms = refined + (class_ids.float() * 2.0)[..., None]
    nms_scores = torch.where(keep, class_scores, neg_inf)
    max_out = min(r, max_instances * max(num_classes - 1, 1))
    idx, valid = nms_padded(boxes_for_nms.contiguous(), nms_scores.contiguous(), max_out, nms_threshold)
    # Padding slots (idx 0, not valid) go to a sentinel column, so they
    # cannot overwrite a genuine keep of roi 0.
    safe_idx = torch.where(valid, idx.long(), torch.full_like(idx, r, dtype=torch.long))
    kept = torch.zeros(b, r + 1, dtype=torch.bool, device=rois.device)
    kept.scatter_(1, safe_idx, True)
    kept = kept[:, :r]
    if num_classes > 2:  # cap each class's survivors at max_instances
        order = top_k(torch.where(kept, class_scores, neg_inf), r)[1]
        ranked_cls = torch.gather(class_ids, 1, order)
        onehot = ranked_cls[..., None] == torch.arange(num_classes, device=rois.device)
        within = onehot.int().cumsum(1)
        rank_in_class = torch.gather(within, 2, ranked_cls[..., None])[..., 0]
        over_cap = torch.zeros_like(kept).scatter_(1, order, rank_in_class > max_instances)
        kept &= ~over_cap

    top_scores, top_idx = top_k(torch.where(kept, class_scores, neg_inf), max_instances)
    det = torch.cat(
        [
            torch.gather(refined, 1, top_idx[..., None].expand(-1, -1, 4)),
            torch.gather(class_ids, 1, top_idx)[..., None].float(),
            torch.gather(class_scores, 1, top_idx)[..., None],
        ],
        dim=2,
    )
    return torch.where((top_scores > float("-inf"))[..., None], det, torch.zeros_like(det))
