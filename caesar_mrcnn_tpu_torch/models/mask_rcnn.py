"""Mask R-CNN assembly (port of ``caesar_mrcnn_tpu/models/mask_rcnn.py``).

``MaskRCNN`` holds the trainable modules. :func:`forward_inference` is the
detect graph: features, RPN, proposals (NMS kernel), ROIAlign at 7 (kernel),
classifier, refinement (NMS kernel), ROIAlign at 14 (kernel), mask head,
the detected class's mask channel, and the u8 mask wire.
:func:`forward_train` is the training graph: features, RPN, proposals (NMS
kernel) and targets (crop_and_resize kernel) without gradient, ROIAlign at
7 and at 14 on the positive prefix (kernel, with its backward kernel), and
the heads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.roi_align import roi_align
from .backbone import FPN, ResNet, stage_widths
from .detection import refine_detections
from .heads import ClassifierHead, MaskHead
from .proposals import generate_proposals
from .rpn import RPNHead
from .targets import detection_targets


def compute_dtype(config) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


class MaskRCNN(nn.Module):
    """Module tree; parameters f32, activations in ``compute_dtype`` on
    channels_last NCHW tensors."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config)
        widths = [w[2] for w in stage_widths(config.backbone)[1]]
        ch = config.top_down_pyramid_size
        self.backbone = ResNet(config.backbone, config.image_channel_count)
        self.fpn = FPN(tuple(widths), ch)
        self.rpn_head = RPNHead(ch, len(config.rpn_anchor_ratios), config.rpn_anchor_stride)
        self.classifier_head = ClassifierHead(
            config.num_classes, config.pool_size, config.fpn_classif_fc_layers_size, ch
        )
        self.mask_head = MaskHead(config.num_classes, ch)

    def features(self, images: torch.Tensor):
        """images NHWC [B, H, W, C] -> (P2, ..., P6), NCHW channels_last."""
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return self.fpn(*self.backbone(x))

    def rpn(self, pyramid: Sequence[torch.Tensor]):
        """Shared RPN on every level, concatenated over anchors."""
        outs = [self.rpn_head(p) for p in pyramid]
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def classifier(self, pooled: torch.Tensor):
        """pooled [B, R, p, p, C] -> (logits, probs [B, R, K], deltas [B, R, K, 4])."""
        b, r = pooled.shape[:2]
        logits, probs, deltas = self.classifier_head(pooled.flatten(0, 1))
        k = self.config.num_classes
        return logits.view(b, r, k), probs.view(b, r, k), deltas.view(b, r, k, 4)

    def mask(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [B, R, p, p, C] -> masks [B, R, 2p, 2p, K]."""
        b, r = pooled.shape[:2]
        m = self.mask_head(pooled.flatten(0, 1))
        return m.reshape((b, r) + m.shape[1:])


def nhwc_levels(pyramid: Sequence[torch.Tensor]):
    """P2..P5 as NHWC views; channels_last memory makes them contiguous."""
    return [p.permute(0, 2, 3, 1).contiguous() for p in pyramid[:4]]


class InferenceOutput(NamedTuple):
    detections: torch.Tensor  # [B, D, 6] (y1, x1, y2, x2, class, score) normalized
    masks: torch.Tensor       # [B, D, mh, mw] per-detection class mask
    rpn_rois: torch.Tensor    # [B, P, 4]
    rpn_probs: torch.Tensor   # [B, A, 2]


def forward_inference(
    model: MaskRCNN,
    images: torch.Tensor,       # [B, H, W, C] molded, float32
    image_metas: torch.Tensor,  # [B, meta] float32
    anchors: torch.Tensor,      # [A, 4] normalized
    rpn_bbox_std_dev: torch.Tensor,  # [4]
    bbox_std_dev: torch.Tensor,      # [4]
) -> InferenceOutput:
    """The detect graph; every tensor lives on ``images.device`` and nothing
    is read back to the host. ``model`` is a ``MaskRCNN`` or any object
    with its ``config``, ``features``, ``rpn``, ``classifier`` and ``mask``
    (the int8 graph: ``heads_int8.DetectStages``)."""
    cfg = model.config
    pyramid = model.features(images)
    _, rpn_probs, rpn_bbox = model.rpn(pyramid)
    proposals, _ = generate_proposals(
        rpn_probs, rpn_bbox, anchors, rpn_bbox_std_dev,
        proposal_count=cfg.post_nms_rois_inference,
        nms_threshold=cfg.rpn_nms_threshold,
        pre_nms_limit=cfg.pre_nms_limit,
    )

    levels = nhwc_levels(pyramid)
    image_shape = cfg.image_shape[:2]
    pooled = roi_align(levels, proposals, image_shape, cfg.pool_size)
    _, probs, deltas = model.classifier(pooled)

    # window in normalized coordinates
    h = image_metas[:, 4:5]
    w = image_metas[:, 5:6]
    scale = torch.cat([h - 1, w - 1, h - 1, w - 1], dim=1)
    shift = torch.cat([torch.zeros_like(h), torch.zeros_like(h),
                       torch.ones_like(h), torch.ones_like(h)], dim=1)
    windows = (image_metas[:, 7:11] - shift) / scale

    detections = refine_detections(
        proposals, probs, deltas, windows, bbox_std_dev,
        num_classes=cfg.num_classes,
        max_instances=cfg.detection_max_instances,
        min_confidence=cfg.detection_min_confidence,
        nms_threshold=cfg.detection_nms_threshold,
    )

    mask_pooled = roi_align(levels, detections[..., :4].contiguous(), image_shape,
                            cfg.mask_pool_size)
    mrcnn_mask = model.mask(mask_pooled)  # [B, D, mh, mw, K]
    det_class = detections[..., 4].long()
    idx = det_class[:, :, None, None, None].expand(-1, -1, *mrcnn_mask.shape[2:4], 1)
    masks = torch.gather(mrcnn_mask, 4, idx)[..., 0]
    if cfg.mask_wire_dtype == "uint8":
        # u8 wire: unmold thresholds at 0.5 after a bilinear resize, so the
        # 1/255 quantization is invisible there
        masks = torch.round(masks * 255.0).to(torch.uint8)
    return InferenceOutput(detections, masks, proposals, rpn_probs)


# ---------------------------------------------------------------- training


class TrainForward(NamedTuple):
    rpn_class_logits: torch.Tensor  # [B, A, 2]
    rpn_bbox: torch.Tensor          # [B, A, 4]
    class_logits: torch.Tensor      # [B, R, C]
    bbox_deltas: torch.Tensor       # [B, R, C, 4]
    masks: torch.Tensor             # [B, Rp, mh, mw, C], positive-ROI prefix only
    target_class_ids: torch.Tensor  # [B, R]
    target_deltas: torch.Tensor     # [B, R, 4]
    target_masks: torch.Tensor      # [B, R, mh, mw]
    rois: torch.Tensor              # [B, R, 4]


def check_train_config(cfg) -> None:
    """Refuse the training options the port does not have yet (ROADMAP A11)."""
    if getattr(cfg, "train_remat", "none") != "none":
        raise NotImplementedError("train_remat other than 'none' is not ported yet (ROADMAP A11)")
    if cfg.train_bn:
        raise NotImplementedError("train_bn=True is not ported yet (ROADMAP A11)")


def forward_train(
    model: MaskRCNN,
    images: torch.Tensor,        # [B, H, W, C] molded, float32
    gt_class_ids: torch.Tensor,  # [B, G] zero-padded; negative = crowd
    gt_boxes: torch.Tensor,      # [B, G, 4] normalized, zero-padded
    gt_masks: torch.Tensor,      # [B, mH, mW, G] float32
    anchors: torch.Tensor,       # [A, 4] normalized
    rpn_bbox_std_dev: torch.Tensor,
    ext_rois: Optional[torch.Tensor] = None,
    priorities: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> TrainForward:
    """Training forward: head outputs and sampled targets (frozen batch
    norm; the JAX ``forward_train`` with ``train_remat="none"``).

    Proposals and targets are built without gradient: they are labels.
    ``ext_rois`` [B, P, 4] replaces the proposals (head-only training with
    given ROIs); the RPN still runs for its losses. ``priorities`` and
    ``generator`` go to :func:`~.targets.detection_targets`. The mask head
    runs on the positive prefix of the ROIs only: the targets put every
    positive there, and the mask loss ignores the other slots.
    """
    cfg = model.config
    check_train_config(cfg)
    pyramid = model.features(images)
    rpn_logits, rpn_probs, rpn_bbox = model.rpn(pyramid)

    with torch.no_grad():
        if ext_rois is None:
            proposals, _ = generate_proposals(
                rpn_probs, rpn_bbox, anchors, rpn_bbox_std_dev,
                proposal_count=cfg.post_nms_rois_training,
                nms_threshold=cfg.rpn_nms_threshold,
                pre_nms_limit=cfg.pre_nms_limit,
            )
        else:
            proposals = ext_rois.float()
        rois, target_class_ids, target_deltas, target_masks = detection_targets(
            proposals, gt_class_ids, gt_boxes, gt_masks, cfg,
            priorities=priorities, generator=generator,
        )

    levels = nhwc_levels(pyramid)
    image_shape = cfg.image_shape[:2]
    pooled = roi_align(levels, rois, image_shape, cfg.pool_size)
    class_logits, _, bbox_deltas = model.classifier(pooled)

    pos_cap = int(cfg.train_rois_per_image * cfg.roi_positive_ratio)
    mask_pooled = roi_align(levels, rois[:, :pos_cap].contiguous(), image_shape, cfg.mask_pool_size)
    masks = model.mask(mask_pooled)
    return TrainForward(
        rpn_class_logits=rpn_logits,
        rpn_bbox=rpn_bbox,
        class_logits=class_logits,
        bbox_deltas=bbox_deltas,
        masks=masks,
        target_class_ids=target_class_ids,
        target_deltas=target_deltas,
        target_masks=target_masks,
        rois=rois,
    )
