"""Plain PyTorch reference of the Mask R-CNN detect graph, in float32.

Written from the published model (He et al. 2017, with the layers of
matterport's Keras Mask R-CNN that SKA-INAF/mrcnn runs): a Caffe-style
ResNet (stride in each stage's first 1x1 convolution; frozen batch norm
with epsilon 1e-3), the FPN (1x1 laterals, nearest 2x upsampling, 3x3
outputs, P6 = P5 at stride 2), the shared RPN (3x3 to 512, 1x1 to 2 and 4
per anchor), TensorFlow's ``crop_and_resize`` on each box's FPN level,
the box head (a 7x7 VALID convolution and a 1x1, each with batch norm, then
the class and box denses) and the mask head (four 3x3 convolutions with
batch norm, a 2x2 stride-2 transposed convolution, a 1x1 with a sigmoid).
One departure from matterport, which the JAX package and its port share:
the log-scale box deltas are clamped at log(1000 / 16) before ``exp``.

It takes a state dict of plain tensors under the names of
:func:`param_spec` and imports nothing of the program: no kernel, no
module, no weight that the program made. Every function computes in the
dtype of its inputs; the callers give it float32 with TF32 switched off
(:func:`exact_f32`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (stem width, blocks per stage, (f1, f2, f3) per stage)
_RESNET = ((64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048))
ARCH = {
    "resnet50": (64, (3, 4, 6, 3), _RESNET),
    "resnet101": (64, (3, 4, 23, 3), _RESNET),
    # the repository's small test backbone
    "custom": (16, (3, 4, 2, 3), ((16, 16, 64), (32, 32, 128), (64, 64, 256), (128, 128, 512))),
}
BN_EPS = 1e-3
MAX_DELTA_LOG = math.log(1000.0 / 16.0)


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """TF32 off for matrix products and convolutions, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def blocks(arch: str) -> Iterator[Tuple[int, int, str, Tuple[int, int, int]]]:
    """(stage, index, name, widths) of every bottleneck: res2a, res2b, ..."""
    _, counts, widths = ARCH[arch]
    for s, (n, f) in enumerate(zip(counts, widths)):
        for j in range(n):
            yield s, j, f"res{s + 2}{chr(97 + j)}", f


def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every tensor of the model: (name, shape, kind, fan_in). Kinds:
    ``weight`` (fan_in inputs per output), ``bias``, and the batch norms'
    ``scale``, ``shift``, ``mean``, ``var``."""
    spec: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def conv(name, cout, cin, k, transposed=False):
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        spec.append((f"{name}.weight", shape, "weight", cin * k * k))
        spec.append((f"{name}.bias", (cout,), "bias", 0))

    def dense(name, cout, cin):
        spec.append((f"{name}.weight", (cout, cin), "weight", cin))
        spec.append((f"{name}.bias", (cout,), "bias", 0))

    def bn(name, c):
        for leaf, kind in (("scale", "scale"), ("bias", "shift"), ("mean", "mean"), ("var", "var")):
            spec.append((f"{name}.{leaf}", (c,), kind, 0))

    stem, _, widths = ARCH[cfg["backbone"]]
    conv("backbone.conv1", stem, cfg["image_channel_count"], 7)
    bn("backbone.bn_conv1", stem)
    cin = stem
    for _, j, name, (f1, f2, f3) in blocks(cfg["backbone"]):
        p = f"backbone.{name}"
        conv(f"{p}.conv1", f1, cin, 1)
        bn(f"{p}.bn1", f1)
        conv(f"{p}.conv2", f2, f1, 3)
        bn(f"{p}.bn2", f2)
        conv(f"{p}.conv3", f3, f2, 1)
        bn(f"{p}.bn3", f3)
        if j == 0:
            conv(f"{p}.shortcut", f3, cin, 1)
            bn(f"{p}.shortcut_bn", f3)
        cin = f3
    ch = cfg["top_down_pyramid_size"]
    for lvl, (_, _, f3) in zip((2, 3, 4, 5), widths):
        conv(f"fpn.fpn_c{lvl}p{lvl}", ch, f3, 1)
    for lvl in (2, 3, 4, 5):
        conv(f"fpn.fpn_p{lvl}", ch, ch, 3)
    a = len(cfg["rpn_anchor_ratios"])
    conv("rpn_head.rpn_conv_shared", 512, ch, 3)
    conv("rpn_head.rpn_class_raw", 2 * a, 512, 1)
    conv("rpn_head.rpn_bbox_pred", 4 * a, 512, 1)
    fc, k = cfg["fpn_classif_fc_layers_size"], cfg["num_classes"]
    conv("classifier_head.mrcnn_class_conv1", fc, ch, cfg["pool_size"])
    bn("classifier_head.mrcnn_class_bn1", fc)
    conv("classifier_head.mrcnn_class_conv2", fc, fc, 1)
    bn("classifier_head.mrcnn_class_bn2", fc)
    dense("classifier_head.mrcnn_class_logits", k, fc)
    dense("classifier_head.mrcnn_bbox_fc", 4 * k, fc)
    cin = ch
    for i in range(1, 5):
        conv(f"mask_head.mrcnn_mask_conv{i}", 256, cin, 3)
        bn(f"mask_head.mrcnn_mask_bn{i}", 256)
        cin = 256
    conv("mask_head.mrcnn_mask_deconv", 256, 256, 2, transposed=True)
    conv("mask_head.mrcnn_mask", k, 256, 1)
    return spec


# ------------------------------------------------------------------ layers


def _conv(x, sd, name, stride=1, padding=0):
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"], stride, padding)


def _bn(x, sd, name):
    mul = sd[f"{name}.scale"] / torch.sqrt(sd[f"{name}.var"] + BN_EPS)
    add = sd[f"{name}.bias"] - sd[f"{name}.mean"] * mul
    return x * mul[:, None, None] + add[:, None, None]


def _max_pool_same(x, k=3, s=2):
    """TensorFlow's SAME max pool: the rest of the padding at the end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


def features(sd: Dict[str, torch.Tensor], cfg: Dict, images: torch.Tensor) -> List[torch.Tensor]:
    """Molded NHWC images -> P2..P6, NCHW."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, sd, "backbone.conv1", 2, 3), sd, "backbone.bn_conv1"))
    x = _max_pool_same(x)
    cs = [None] * 4
    for s, j, name, _ in blocks(cfg["backbone"]):
        p = f"backbone.{name}"
        stride = 2 if (j == 0 and s > 0) else 1
        y = F.relu(_bn(_conv(x, sd, f"{p}.conv1", stride), sd, f"{p}.bn1"))
        y = F.relu(_bn(_conv(y, sd, f"{p}.conv2", 1, 1), sd, f"{p}.bn2"))
        y = _bn(_conv(y, sd, f"{p}.conv3"), sd, f"{p}.bn3")
        sc = x if j else _bn(_conv(x, sd, f"{p}.shortcut", stride), sd, f"{p}.shortcut_bn")
        x = cs[s] = F.relu(y + sc)
    c2, c3, c4, c5 = cs

    def up(t):
        return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    p5 = _conv(c5, sd, "fpn.fpn_c5p5")
    p4 = up(p5) + _conv(c4, sd, "fpn.fpn_c4p4")
    p3 = up(p4) + _conv(c3, sd, "fpn.fpn_c3p3")
    p2 = up(p3) + _conv(c2, sd, "fpn.fpn_c2p2")
    out = [_conv(p, sd, f"fpn.fpn_p{lvl}", 1, 1) for lvl, p in zip((2, 3, 4, 5), (p2, p3, p4, p5))]
    return out + [out[3][:, :, ::2, ::2]]


def rpn(sd: Dict[str, torch.Tensor], pyramid: Sequence[torch.Tensor]):
    """(logits, probs [B, A, 2], deltas [B, A, 4]) over P2..P6, anchors in
    (level, y, x, ratio) order."""
    logits, deltas = [], []
    for p in pyramid:
        shared = F.relu(_conv(p, sd, "rpn_head.rpn_conv_shared", 1, 1))
        b = p.shape[0]
        logits.append(_conv(shared, sd, "rpn_head.rpn_class_raw").permute(0, 2, 3, 1).reshape(b, -1, 2))
        deltas.append(_conv(shared, sd, "rpn_head.rpn_bbox_pred").permute(0, 2, 3, 1).reshape(b, -1, 4))
    logits = torch.cat(logits, 1)
    return logits, torch.softmax(logits, -1), torch.cat(deltas, 1)


def anchors(cfg: Dict, image_shape: Tuple[int, int]) -> np.ndarray:
    """Normalized pyramid anchors [A, 4] (y1, x1, y2, x2), f32: per level,
    every (scale, ratio) box centred at each cell origin times the stride,
    heights scale / sqrt(ratio), widths scale * sqrt(ratio)."""
    h, w = image_shape
    out = []
    for scale, stride in zip(cfg["rpn_anchor_scales"], cfg["backbone_strides"]):
        fh, fw = math.ceil(h / stride), math.ceil(w / stride)
        ratios = np.asarray(cfg["rpn_anchor_ratios"], dtype=np.float64)
        hs, ws = scale / np.sqrt(ratios), scale * np.sqrt(ratios)
        cy, cx = np.meshgrid(np.arange(fh) * stride, np.arange(fw) * stride, indexing="ij")
        cy = np.repeat(cy.reshape(-1, 1), len(ratios), 1).reshape(-1).astype(np.float64)
        cx = np.repeat(cx.reshape(-1, 1), len(ratios), 1).reshape(-1).astype(np.float64)
        bh, bw = np.tile(hs, fh * fw), np.tile(ws, fh * fw)
        out.append(np.stack([cy - 0.5 * bh, cx - 0.5 * bw, cy + 0.5 * bh, cx + 0.5 * bw], 1))
    boxes = np.concatenate(out)
    scale = np.array([h - 1, w - 1, h - 1, w - 1], dtype=np.float64)
    return ((boxes - np.array([0, 0, 1, 1])) / scale).astype(np.float32)


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """(dy, dx, log dh, log dw) applied to (y1, x1, y2, x2)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h + deltas[..., 0] * h
    cx = boxes[..., 1] + 0.5 * w + deltas[..., 1] * w
    h = h * torch.exp(deltas[..., 2].clamp(-MAX_DELTA_LOG, MAX_DELTA_LOG))
    w = w * torch.exp(deltas[..., 3].clamp(-MAX_DELTA_LOG, MAX_DELTA_LOG))
    y1, x1 = cy - 0.5 * h, cx - 0.5 * w
    return torch.stack([y1, x1, y1 + h, x1 + w], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N, M] of [..., N, 4] and [..., M, 4]; 0 where the
    union is empty."""
    y1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-30), torch.zeros_like(union))


def roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor, image_shape: Tuple[int, int],
              pool: int) -> torch.Tensor:
    """TensorFlow's ``crop_and_resize`` of each box on its FPN level:
    levels P2..P5 NCHW, boxes [B, N, 4] normalized -> [B, N, pool, pool, C].
    Sample i of a box lies at ``(y1 + (y2 - y1) t_i) (H - 1)`` with ``t =
    linspace(0, 1, pool)``, so that the last lands on ``y2 (H - 1)``
    exactly, as in the JAX package (a box clipped to the tile's edge then
    samples the edge row, where TensorFlow's rounding can put it a hair
    outside); a sample outside [0, H - 1] reads 0. The level is ``4 +
    round(log2(sqrt(h w) / (224 / sqrt(image area))))``, clamped to P2..P5."""
    b, n = boxes.shape[:2]
    c = levels[0].shape[1]
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    area = float(image_shape[0] * image_shape[1])
    k = 4.0 + torch.round(torch.log2(torch.sqrt(torch.clamp_min(h * w, 1e-12)) / (224.0 / math.sqrt(area))))
    level = k.clamp(2, 5).long() - 2
    out = boxes.new_zeros(b, n, pool, pool, c)
    t = torch.linspace(0.0, 1.0, pool, dtype=boxes.dtype, device=boxes.device)
    for lvl, fmap in enumerate(levels[:4]):
        bi, ni = torch.nonzero(level == lvl, as_tuple=True)
        if bi.numel() == 0:
            continue
        fm = fmap.permute(0, 2, 3, 1)  # [B, H, W, C]
        hh, ww = fm.shape[1], fm.shape[2]
        bx = boxes[bi, ni]

        def axis(lo, hi, extent):
            pos = (lo[:, None] + (hi - lo)[:, None] * t[None, :]) * (extent - 1)
            inside = (pos >= 0) & (pos <= extent - 1)
            p0 = torch.floor(pos).clamp(0, extent - 1)
            p1 = torch.ceil(pos).clamp(0, extent - 1)
            return inside, p0.long(), p1.long(), pos - torch.floor(pos)

        iy, y0, y1, fy = axis(bx[:, 0], bx[:, 2], hh)
        ix, x0, x1, fx = axis(bx[:, 1], bx[:, 3], ww)
        img = bi[:, None, None]

        def tap(yy, xx):
            return fm[img, yy[:, :, None], xx[:, None, :]]  # [M, pool, pool, C]

        fx_, fy_ = fx[:, None, :, None], fy[:, :, None, None]
        top = tap(y0, x0) + (tap(y0, x1) - tap(y0, x0)) * fx_
        bot = tap(y1, x0) + (tap(y1, x1) - tap(y1, x0)) * fx_
        val = top + (bot - top) * fy_
        inside = (iy[:, :, None] & ix[:, None, :])[..., None]
        out[bi, ni] = torch.where(inside, val, torch.zeros_like(val))
    return out


def classifier(sd: Dict[str, torch.Tensor], pooled: torch.Tensor):
    """pooled [B, N, p, p, C] -> (probs [B, N, K], deltas [B, N, K, 4])."""
    b, n = pooled.shape[:2]
    x = pooled.flatten(0, 1).permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, sd, "classifier_head.mrcnn_class_conv1"), sd, "classifier_head.mrcnn_class_bn1"))
    x = F.relu(_bn(_conv(x, sd, "classifier_head.mrcnn_class_conv2"), sd, "classifier_head.mrcnn_class_bn2"))
    x = x.flatten(1)
    logits = F.linear(x, sd["classifier_head.mrcnn_class_logits.weight"], sd["classifier_head.mrcnn_class_logits.bias"])
    deltas = F.linear(x, sd["classifier_head.mrcnn_bbox_fc.weight"], sd["classifier_head.mrcnn_bbox_fc.bias"])
    k = logits.shape[-1]
    return torch.softmax(logits, -1).view(b, n, k), deltas.view(b, n, k, 4)


def mask_head(sd: Dict[str, torch.Tensor], pooled: torch.Tensor) -> torch.Tensor:
    """pooled [B, N, p, p, C] -> per-class sigmoid masks [B, N, K, 2p, 2p]."""
    b, n = pooled.shape[:2]
    x = pooled.flatten(0, 1).permute(0, 3, 1, 2)
    for i in range(1, 5):
        x = F.relu(_bn(_conv(x, sd, f"mask_head.mrcnn_mask_conv{i}", 1, 1), sd, f"mask_head.mrcnn_mask_bn{i}"))
    x = F.relu(F.conv_transpose2d(x, sd["mask_head.mrcnn_mask_deconv.weight"],
                                  sd["mask_head.mrcnn_mask_deconv.bias"], stride=2))
    m = torch.sigmoid(_conv(x, sd, "mask_head.mrcnn_mask"))
    return m.view(b, n, *m.shape[1:])
