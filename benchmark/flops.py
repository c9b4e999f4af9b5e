"""Floating-point operations of the model's convolutions and matrix
products, counted from the configuration's shapes: 2 per multiply-add,
whatever implements the step. Batch norms, activations, ROIAlign, NMS and
the box arithmetic are left out; they are a small share of the work.
"""

from __future__ import annotations

import math
from typing import Dict

from .reference.mrcnn import ARCH, blocks


def _out(size: int, stride: int) -> int:
    return math.ceil(size / stride)


def backbone_macs(arch: str, h: int, w: int, channels: int = 3) -> Dict[str, int]:
    """Multiply-adds of the ResNet's convolutions at an h x w input: the
    stem and each stage (C2..C5)."""
    stem, _, _ = ARCH[arch]
    h, w = _out(h, 2), _out(w, 2)
    macs = {"stem": h * w * stem * channels * 49}
    h, w = _out(h, 2), _out(w, 2)  # max pool
    cin = stem
    for s, j, _, (f1, f2, f3) in blocks(arch):
        stride = 2 if (j == 0 and s > 0) else 1
        h, w = _out(h, stride), _out(w, stride)
        m = h * w * (f1 * cin + f2 * f1 * 9 + f3 * f2)
        if j == 0:
            m += h * w * f3 * cin
        macs[f"C{s + 2}"] = macs.get(f"C{s + 2}", 0) + m
        cin = f3
    return macs


def detect_macs(cfg: Dict, rois: int = None, detections: int = None) -> Dict[str, int]:
    """Multiply-adds per image of the detect graph at ``cfg``'s input
    size: backbone, FPN, RPN on P2..P6, the box head at ``rois``
    proposals (``post_nms_rois_inference``) and the mask head at
    ``detections`` (``detection_max_instances``)."""
    h, w = cfg["image_max_dim"], cfg["image_max_dim"]
    rois = cfg["post_nms_rois_inference"] if rois is None else rois
    detections = cfg["detection_max_instances"] if detections is None else detections
    _, _, widths = ARCH[cfg["backbone"]]
    ch, a = cfg["top_down_pyramid_size"], len(cfg["rpn_anchor_ratios"])
    out = {"backbone": sum(backbone_macs(cfg["backbone"], h, w, cfg["image_channel_count"]).values())}
    shapes = [(_out(h, s), _out(w, s)) for s in cfg["backbone_strides"]]
    fpn = 0
    for (lh, lw), (_, _, f3) in zip(shapes[:4], widths):
        fpn += lh * lw * ch * f3 + lh * lw * ch * ch * 9
    out["fpn"] = fpn
    out["rpn"] = sum(lh * lw * (512 * ch * 9 + 6 * a * 512) for lh, lw in shapes)
    fc, k, p = cfg["fpn_classif_fc_layers_size"], cfg["num_classes"], cfg["pool_size"]
    out["box_head"] = rois * (p * p * ch * fc + fc * fc + fc * 5 * k)
    mp = cfg["mask_pool_size"]
    out["mask_head"] = detections * (mp * mp * (ch * 256 * 9 + 3 * 256 * 256 * 9) + mp * mp * 256 * 256 * 4
                                     + (2 * mp) ** 2 * 256 * k)
    return out


def detect_flops_per_image(cfg: Dict) -> float:
    """2 x the multiply-adds of :func:`detect_macs`."""
    return 2.0 * sum(detect_macs(cfg).values())
