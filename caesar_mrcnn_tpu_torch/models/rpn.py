"""Region Proposal Network head, shared across P2..P6 (port of
``caesar_mrcnn_tpu/models/rpn.py``; the ``rpn_fused_heads`` variant is not
ported)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class RPNHead(nn.Module):
    """3x3/512 shared conv, then 1x1 objectness (2 per anchor) and 1x1
    deltas (4 per anchor)."""

    def __init__(self, in_channels: int, anchors_per_location: int = 3,
                 anchor_stride: int = 1):
        super().__init__()
        if anchor_stride != 1:
            raise ValueError("only rpn_anchor_stride=1 is ported")
        a = anchors_per_location
        self.rpn_conv_shared = Conv2d(in_channels, 512, 3, padding=1)
        self.rpn_class_raw = Conv2d(512, 2 * a, 1)
        self.rpn_bbox_pred = Conv2d(512, 4 * a, 1)

    def forward(self, feature_map: torch.Tensor):
        """[B, C, H, W] -> (logits, probs [B, H*W*A, 2], deltas [B, H*W*A, 4]),
        anchors in (h, w, a) order like ``utils/anchors.py``."""
        b = feature_map.shape[0]
        shared = F.relu(self.rpn_conv_shared(feature_map))
        logits = self.rpn_class_raw(shared).permute(0, 2, 3, 1).reshape(b, -1, 2).float()
        bbox = self.rpn_bbox_pred(shared).permute(0, 2, 3, 1).reshape(b, -1, 4).float()
        return logits, torch.softmax(logits, dim=-1), bbox
