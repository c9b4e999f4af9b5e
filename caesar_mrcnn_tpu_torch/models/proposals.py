"""Proposal generation: RPN outputs + anchors -> NMS'd ROIs, batched (port of
``caesar_mrcnn_tpu/models/proposals.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.nms import nms_padded
from ..utils.boxes import apply_box_deltas


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: ties keep the lower index
    first, which ``torch.topk`` does not promise."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def generate_proposals(
    rpn_probs: torch.Tensor,         # [B, A, 2]
    rpn_bbox: torch.Tensor,          # [B, A, 4]
    anchors: torch.Tensor,           # [A, 4] normalized
    rpn_bbox_std_dev: torch.Tensor,  # [4]
    proposal_count: int,
    nms_threshold: float,
    pre_nms_limit: int = 6000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (proposals [B, proposal_count, 4] zero-padded, valid [B, P])."""
    scores = rpn_probs[..., 1]
    deltas = rpn_bbox * rpn_bbox_std_dev
    k = min(pre_nms_limit, scores.shape[1])
    top_scores, ix = top_k(scores, k)
    top_deltas = torch.gather(deltas, 1, ix[..., None].expand(-1, -1, 4))
    # clip to the unit window (0, 0, 1, 1)
    boxes = apply_box_deltas(anchors[ix], top_deltas).clamp(0.0, 1.0).contiguous()
    idx, valid = nms_padded(boxes, top_scores.contiguous(), proposal_count, nms_threshold)
    kept = torch.gather(boxes, 1, idx.long()[..., None].expand(-1, -1, 4))
    return torch.where(valid[..., None], kept, torch.zeros_like(kept)), valid
