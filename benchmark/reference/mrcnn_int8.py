"""Plain PyTorch reference of the Mask R-CNN's int8 serving graph.

Post-training quantization as published for integer inference (Jacob et
al. 2018, symmetric variant), applied to the detect graph of
:mod:`.mrcnn` at every convolution of the backbone, the FPN, the RPN's
shared 3x3, the box head's two convolutions and the mask head's four 3x3s
(123 "sites" at ResNet-101):

* each frozen batch norm folded into the convolution before it:
  ``w' = w g / sqrt(v + eps)``, ``b' = (b - m) g / sqrt(v + eps) + beta``;
* weights symmetric int8 per output channel: ``s_w = max|w'| / 127``,
  ``w_q = round_half_even(w' / s_w)``;
* activations symmetric int8 per tensor, one scale per site:
  ``s = max|x| / 127`` of the site's input over the calibration batch,
  observed while the folded float32 graph runs on it, the box head on the
  proposals and the mask head on the detections that this graph chooses
  there itself (:func:`proposals`, :func:`detections`: top-k, greedy NMS,
  the per-class detection layer, written plainly). The RPN's shared
  convolution has one scale per pyramid level (``rpn/shared@p2`` ..
  ``@p6``) over one set of weights;
* the quantizer ``clip(round_half_even(x / s), -127, 127)``;
* the convolution: integer sums of int8 input and int8 weights, exact
  (float64 holds every partial sum, below 2^53, and a non-exact algorithm's
  error is rounded away), then the float32 epilogue ``acc * (s_w s) + b'``,
  a product and a sum each rounded, and the ReLU. A convolution whose
  output feeds one quantized convolution alone hands it on quantized at
  that convolution's scale, which is the next site's own quantizer: the
  reference quantizes each site's input and needs no special case.

The residual stream, the FPN's sums and everything between two sites stay
float32. The pyramid and the pooled features are rounded to the
configuration's ``compute_dtype`` where the graph hands them on (the
pyramid leaves the FPN in it; ROIAlign returns it), as the configuration
states.

**Departure from the program:** the float layers (the RPN's 1x1 heads, the
class and box denses, the mask head's transposed convolution and its 1x1)
run in float32 here; the program runs them in its ``compute_dtype``
(bfloat16).

Names: a site is ``bb/<conv>`` (``bb/conv1``, ``bb/res4b/conv2``,
``bb/res3a/shortcut``), ``fpn/c5p5`` .. ``fpn/p2``, ``rpn/shared@<level>``,
``cls/conv1``, ``cls/conv2``, ``mask/conv1`` .. ``mask/conv4``. The
weights are a state dict under :func:`.mrcnn.param_spec`'s names. Nothing of
the program is imported; the layers that carry no quantization are
:mod:`.mrcnn`'s.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import mrcnn as R

QMAX = 127
LEVELS = ("p2", "p3", "p4", "p5", "p6")
STORE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _conv_names(cfg: Dict) -> Dict[str, Tuple[str, Optional[str]]]:
    """{site without its level: (conv name, batch norm name or None)}."""
    out = {"bb/conv1": ("backbone.conv1", "backbone.bn_conv1")}
    for _, j, name, _ in R.blocks(cfg["backbone"]):
        p = f"backbone.{name}"
        for i in (1, 2, 3):
            out[f"bb/{name}/conv{i}"] = (f"{p}.conv{i}", f"{p}.bn{i}")
        if j == 0:
            out[f"bb/{name}/shortcut"] = (f"{p}.shortcut", f"{p}.shortcut_bn")
    for lvl in (5, 4, 3, 2):
        out[f"fpn/c{lvl}p{lvl}"] = (f"fpn.fpn_c{lvl}p{lvl}", None)
    for lvl in (2, 3, 4, 5):
        out[f"fpn/p{lvl}"] = (f"fpn.fpn_p{lvl}", None)
    out["rpn/shared"] = ("rpn_head.rpn_conv_shared", None)
    for i in (1, 2):
        out[f"cls/conv{i}"] = (f"classifier_head.mrcnn_class_conv{i}", f"classifier_head.mrcnn_class_bn{i}")
    for i in range(1, 5):
        out[f"mask/conv{i}"] = (f"mask_head.mrcnn_mask_conv{i}", f"mask_head.mrcnn_mask_bn{i}")
    return out


def fold(sd: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{site without its level: (w' OIHW, b')}, float32, batch norms folded."""
    out = {}
    for base, (conv, bn) in _conv_names(cfg).items():
        w, b = sd[f"{conv}.weight"], sd[f"{conv}.bias"]
        if bn is not None:
            # the f32 square root correctly rounded on any device, through f64
            # (PyTorch's vectorised CPU square root may be an ulp off)
            inv = sd[f"{bn}.scale"] / torch.sqrt((sd[f"{bn}.var"] + R.BN_EPS).double()).float()
            w, b = w * inv[:, None, None, None], (b - sd[f"{bn}.mean"]) * inv + sd[f"{bn}.bias"]
        out[base] = (w, b)
    return out


def _div(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s``, a true division on any device (a CUDA tensor divided by a
    host number is multiplied by its reciprocal)."""
    return x / torch.as_tensor(s, dtype=torch.float32, device=x.device)


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 levels of ``w`` OIHW as float32, ``s_w`` [O]): per output
    channel, symmetric."""
    s_w = _div(w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12), float(QMAX))
    return torch.round(w / s_w[:, None, None, None]).clamp(-QMAX, QMAX), s_w


def quantize(x: torch.Tensor, s: float) -> torch.Tensor:
    """``clip(round_half_even(x / s), -127, 127)``, int8 levels as float32."""
    return torch.round(_div(x.float(), s)).clamp(-QMAX, QMAX)


def scale_of(maxabs: float) -> float:
    """The float32 scale of a tensor whose largest magnitude is ``maxabs``."""
    return float(np.float32(max(float(maxabs), 1e-12) / QMAX))


class Graph:
    """The detect graph's stages over one of two arithmetics: without
    ``scales`` the folded float32 graph, which shows every site's input to
    ``observe`` if given (calibration); given ``scales`` {site: scale}, the
    int8 graph. Tensors are NCHW; ``images`` molded NHWC float32."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, scales: Optional[Dict[str, float]] = None,
                 observe: Optional[Callable[[str, torch.Tensor], None]] = None):
        self.sd, self.cfg, self.scales, self.observe = sd, cfg, scales, observe
        self.folded = fold(sd, cfg)
        self.store = STORE[cfg["compute_dtype"]] if scales is not None else torch.float32
        if scales is not None:
            self.quantized = {base: quantize_weights(w) for base, (w, _) in self.folded.items()}

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.store).float()

    def conv(self, site: str, x: torch.Tensor, stride: int = 1, padding: int = 0, relu: bool = False):
        base = site.split("@")[0]
        w, b = self.folded[base]
        if self.scales is None:
            if self.observe is not None:
                self.observe(site, x)
            y = F.conv2d(x, w, b, stride, padding)
        else:
            wq, s_w = self.quantized[base]
            s = self.scales[site]
            acc = F.conv2d(quantize(x, s).double(), wq.double(), None, stride, padding)
            sw = s_w * torch.tensor(s, dtype=torch.float32, device=x.device)
            y = torch.round(acc).float() * sw[:, None, None] + b[:, None, None]
        return F.relu(y) if relu else y

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Molded NHWC images -> P2..P6, NCHW."""
        x = self.conv("bb/conv1", images.permute(0, 3, 1, 2), 2, 3, relu=True)
        x = R._max_pool_same(x)
        cs = [None] * 4
        for s, j, name, _ in R.blocks(self.cfg["backbone"]):
            stride = 2 if (j == 0 and s > 0) else 1
            y = self.conv(f"bb/{name}/conv1", x, stride, relu=True)
            y = self.conv(f"bb/{name}/conv2", y, 1, 1, relu=True)
            y = self.conv(f"bb/{name}/conv3", y)
            sc = x if j else self.conv(f"bb/{name}/shortcut", x, stride)
            x = cs[s] = F.relu(y + sc)
        c2, c3, c4, c5 = cs

        def up(t):
            return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

        p5 = self.conv("fpn/c5p5", c5)
        p4 = self.conv("fpn/c4p4", c4) + up(p5)
        p3 = self.conv("fpn/c3p3", c3) + up(p4)
        p2 = self.conv("fpn/c2p2", c2) + up(p3)
        out = [self.conv(f"fpn/p{lvl}", p, 1, 1) for lvl, p in zip((2, 3, 4, 5), (p2, p3, p4, p5))]
        return [self._round(p) for p in out + [out[3][:, :, ::2, ::2]]]

    def rpn(self, pyramid: Sequence[torch.Tensor]):
        """(logits, probs [B, A, 2], deltas [B, A, 4]) over P2..P6, as
        :func:`.mrcnn.rpn` orders them."""
        logits, deltas = [], []
        for lvl, p in zip(LEVELS, pyramid):
            shared = self.conv(f"rpn/shared@{lvl}", p, self.cfg["rpn_anchor_stride"], 1, relu=True)
            b = p.shape[0]
            logits.append(R._conv(shared, self.sd, "rpn_head.rpn_class_raw").permute(0, 2, 3, 1).reshape(b, -1, 2))
            deltas.append(R._conv(shared, self.sd, "rpn_head.rpn_bbox_pred").permute(0, 2, 3, 1).reshape(b, -1, 4))
        logits = torch.cat(logits, 1)
        return logits, torch.softmax(logits, -1), torch.cat(deltas, 1)

    def roi_align(self, levels: Sequence[torch.Tensor], boxes: torch.Tensor, image_shape, pool: int):
        """:func:`.mrcnn.roi_align`, its output rounded as the graph hands it on."""
        return self._round(R.roi_align(levels, boxes, image_shape, pool))

    def classifier(self, pooled: torch.Tensor):
        """pooled [B, N, p, p, C] -> (probs [B, N, K], deltas [B, N, K, 4])."""
        b, n = pooled.shape[:2]
        x = pooled.flatten(0, 1).permute(0, 3, 1, 2)
        x = self.conv("cls/conv1", x, relu=True)  # a VALID convolution over the pool window
        x = self.conv("cls/conv2", x, relu=True).flatten(1)
        sd = self.sd
        logits = F.linear(x, sd["classifier_head.mrcnn_class_logits.weight"],
                          sd["classifier_head.mrcnn_class_logits.bias"])
        deltas = F.linear(x, sd["classifier_head.mrcnn_bbox_fc.weight"], sd["classifier_head.mrcnn_bbox_fc.bias"])
        k = logits.shape[-1]
        return torch.softmax(logits, -1).view(b, n, k), deltas.view(b, n, k, 4)

    def mask_head(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [B, N, p, p, C] -> per-class sigmoid masks [B, N, K, 2p, 2p]."""
        b, n = pooled.shape[:2]
        x = pooled.flatten(0, 1).permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = self.conv(f"mask/conv{i}", x, 1, 1, relu=True)
        x = F.relu(F.conv_transpose2d(x, self.sd["mask_head.mrcnn_mask_deconv.weight"],
                                      self.sd["mask_head.mrcnn_mask_deconv.bias"], stride=2))
        m = torch.sigmoid(R._conv(x, self.sd, "mask_head.mrcnn_mask"))
        return m.view(b, n, *m.shape[1:])


def nms(boxes: torch.Tensor, limit: int, threshold: float) -> List[int]:
    """Greedy NMS over ``boxes`` [N, 4] already in score order: the
    positions kept, at most ``limit``; a box is dropped when its IoU with a
    box kept before it exceeds ``threshold``."""
    over = (R.iou(boxes, boxes) > threshold).cpu().numpy()
    dropped = np.zeros(boxes.shape[0], dtype=bool)
    kept: List[int] = []
    for i in range(boxes.shape[0]):
        if dropped[i]:
            continue
        kept.append(i)
        if len(kept) == limit:
            break
        dropped |= over[i]
    return kept


def _by_score(scores: torch.Tensor) -> torch.Tensor:
    """Indices of ``scores`` [N], best first, ties in index order."""
    return torch.sort(scores, descending=True, stable=True).indices


def proposals(cfg: Dict, probs: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """The proposal layer: per image, the ``pre_nms_limit`` anchors of best
    objectness (``probs`` [B, A, 2]), their ``deltas`` [B, A, 4] decoded at
    ``rpn_bbox_std_dev`` on ``anchors`` [A, 4] and clipped to the tile, NMS
    at ``rpn_nms_threshold``: [B, post_nms_rois_inference, 4], zero-padded."""
    std = torch.tensor(cfg["rpn_bbox_std_dev"], dtype=torch.float32, device=deltas.device)
    count = cfg["post_nms_rois_inference"]
    out = deltas.new_zeros(probs.shape[0], count, 4)
    for i in range(probs.shape[0]):
        top = _by_score(probs[i, :, 1])[:cfg["pre_nms_limit"]]
        boxes = R.apply_box_deltas(anchors[top], deltas[i, top] * std).clamp(0.0, 1.0)
        kept = nms(boxes, count, cfg["rpn_nms_threshold"])
        out[i, :len(kept)] = boxes[kept]
    return out


def detections(cfg: Dict, rois: torch.Tensor, probs: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """The detection layer on a tile (its window the whole tile): each of
    ``rois`` [B, R, 4] in its best class of ``probs`` [B, R, K], refined by
    that class's ``deltas`` [B, R, K, 4] at ``bbox_std_dev`` and clipped;
    foreground boxes of non-empty rois at ``detection_min_confidence`` or
    above, NMS per class at ``detection_nms_threshold``, at most
    ``detection_max_instances`` a class, the best of them overall:
    [B, detection_max_instances, 6] (box, class, score), zero-padded."""
    std = torch.tensor(cfg["bbox_std_dev"], dtype=torch.float32, device=deltas.device)
    limit = cfg["detection_max_instances"]
    out = deltas.new_zeros(rois.shape[0], limit, 6)
    for i in range(rois.shape[0]):
        score, cls = probs[i].max(-1)
        rows = torch.arange(rois.shape[1], device=rois.device)
        boxes = R.apply_box_deltas(rois[i], deltas[i, rows, cls] * std).clamp(0.0, 1.0)
        area = (rois[i, :, 2] - rois[i, :, 0]) * (rois[i, :, 3] - rois[i, :, 1])
        candidate = (area > 0) & (cls > 0) & (score >= cfg["detection_min_confidence"])
        kept = []
        for c in torch.unique(cls[candidate]).tolist():
            idx = torch.nonzero(candidate & (cls == c)).flatten()
            idx = idx[_by_score(score[idx])]
            kept.append(idx[nms(boxes[idx], limit, cfg["detection_nms_threshold"])])
        if kept:
            idx = torch.cat(kept).sort().values  # index order, so that ties keep the lower index first
            idx = idx[_by_score(score[idx])][:limit]
            out[i, :len(idx)] = torch.cat([boxes[idx], cls[idx, None].float(), score[idx, None]], 1)
    return out


def calibrate(sd: Dict[str, torch.Tensor], cfg: Dict, images: torch.Tensor) -> Dict[str, float]:
    """Every site's scale over a calibration batch: molded NHWC ``images``
    through the folded float32 graph (TF32 off), the box head on the
    proposals of :func:`proposals` and the mask head on the boxes of
    :func:`detections`, the choices this graph makes on these images."""
    maxabs: Dict[str, float] = {}

    def observe(site, x):
        maxabs[site] = max(maxabs.get(site, 0.0), float(x.abs().amax()))

    g = Graph(sd, cfg, observe=observe)
    shape = tuple(images.shape[1:3])
    with torch.no_grad(), R.exact_f32():
        pyramid = g.features(images.float())
        _, probs, deltas = g.rpn(pyramid)
        anchors = torch.from_numpy(R.anchors(cfg, shape)).to(images.device)
        rois = proposals(cfg, probs, deltas, anchors)
        cls_probs, cls_deltas = g.classifier(g.roi_align(pyramid[:4], rois, shape, cfg["pool_size"]))
        dets = detections(cfg, rois, cls_probs, cls_deltas)
        g.mask_head(g.roi_align(pyramid[:4], dets[..., :4].contiguous(), shape, cfg["mask_pool_size"]))
    return {site: scale_of(v) for site, v in maxabs.items()}
