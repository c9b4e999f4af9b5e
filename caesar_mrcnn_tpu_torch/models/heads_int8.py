"""The int8 post-training-quantized detect graph (the serving path).

Port of ``caesar_mrcnn_tpu/models/heads_int8.py``: the backbone's
quantization (``models/backbone_int8.py``) extended to every conv-heavy
stage of the detect graph: the FPN, the RPN's shared conv, the
classifier's fc1 and fc2 (a 7x7 VALID conv and a 1x1) and the mask head's
3x3 stack. 123 sites at ResNet-101. The small output layers (the RPN's 1x1
heads, the class-logit and box denses, the mask deconv and its 1x1) run in
the model's compute dtype, from the model's own modules.

One stage topology, :class:`DetectStages`, runs in both arithmetic modes:
:func:`folded_stages` (f32 convs on folded weights: calibration and the
fold tests) and :func:`int8_stages` (int8 weights and activations, int32
accumulation on the card's kernels). A stages object has the
``config``/``features``/``rpn``/``classifier``/``mask`` of a ``MaskRCNN``,
so ``mask_rcnn.forward_inference`` runs it unchanged, as the JAX code
passes ``stages=`` to its ``forward_inference``.

Calibration is max-abs over a batch, observed at every quantized conv's
input while the folded f32 graph runs; per tensor, symmetric. The RPN's
shared conv runs once per pyramid level, and each level has its own scale
(sites ``rpn/shared@p2`` .. ``@p6``) over the same int8 weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import weights as W
from .backbone_int8 import FoldedConvs, Int8Convs, exact_f32, fold_bn, fold_conv_bn, quantize_conv, walk_resnet
from .mask_rcnn import compute_dtype, forward_inference

LEVELS = ("p2", "p3", "p4", "p5", "p6")
FPN_CONVS = ("fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2", "fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5")


# ------------------------------------------------------------------ folding


def fold_detect(variables: Dict, cfg) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{site: (w HWIO f32, b f32)} of every quantized conv of the detect
    graph, batch norms folded in (numpy). ``variables`` is the model's
    numpy flax tree (``weights.state_dict_to_flax``). Sites: ``bb/<conv>``
    (the backbone), ``fpn/<name>`` (conv and bias, no batch norm),
    ``rpn/shared``, ``cls/conv{1,2}`` and ``mask/conv{1..4}``."""
    folded = {f"bb/{k}": v for k, v in fold_bn(variables, cfg.backbone).items()}
    p, s = variables["params"], variables["batch_stats"]
    for name in FPN_CONVS:
        cp = p["fpn"][name]
        folded[f"fpn/{name[4:]}"] = (np.asarray(cp["kernel"], np.float32), np.asarray(cp["bias"], np.float32))
    rp = p["rpn_head"]["rpn_conv_shared"]
    folded["rpn/shared"] = (np.asarray(rp["kernel"], np.float32), np.asarray(rp["bias"], np.float32))
    ch, chs = p["classifier_head"], s["classifier_head"]
    for i in (1, 2):
        folded[f"cls/conv{i}"] = fold_conv_bn(ch[f"mrcnn_class_conv{i}"], ch[f"mrcnn_class_bn{i}"]["BatchNorm_0"],
                                              chs[f"mrcnn_class_bn{i}"]["BatchNorm_0"])
    mh, mhs = p["mask_head"], s["mask_head"]
    for i in range(1, 5):
        folded[f"mask/conv{i}"] = fold_conv_bn(mh[f"mrcnn_mask_conv{i}"], mh[f"mrcnn_mask_bn{i}"]["BatchNorm_0"],
                                               mhs[f"mrcnn_mask_bn{i}"]["BatchNorm_0"])
    return folded


def site_module(model: nn.Module, site: str) -> nn.Module:
    """The conv module of ``model`` (a ``MaskRCNN``) behind a site."""
    group, name = site.split("@")[0].split("/", 1)
    if group == "bb":
        return model.backbone.get_submodule(name.replace("/", "."))
    if group == "fpn":
        return getattr(model.fpn, f"fpn_{name}")
    if group == "rpn":
        return model.rpn_head.rpn_conv_shared
    if group == "cls":
        return getattr(model.classifier_head, f"mrcnn_class_{name}")
    return getattr(model.mask_head, f"mrcnn_mask_{name}")


def quantize_detect(folded, act_scales: Dict[str, float]) -> Dict[str, Dict[str, np.ndarray]]:
    """{site: int8 conv pack} for every calibrated site; a site with an
    ``@level`` suffix quantizes its base site's weights at its own scale."""
    return {site: quantize_conv(*folded[site.split("@")[0]], s_in) for site, s_in in act_scales.items()}


# ------------------------------------------------------------------- stages


class DetectStages(nn.Module):
    """The detect graph's four trainable stages over pluggable conv
    arithmetic ``convs(site, x NHWC, stride, relu, then=)`` (f32 NHWC out;
    ``then`` names the one quantized conv that reads the output, the
    backbone's conv1 -> conv2 -> conv3 of each block, the classifier's
    conv1 -> conv2 and the mask head's stack: 70 sites at ResNet-101, whose
    int8 convs quantize in their epilogue), the other layers taken from
    ``model`` and run in ``dtype``. The backbone's residual stream and the
    FPN are f32; the pyramid leaves in ``dtype``."""

    def __init__(self, model: nn.Module, convs: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.config = model.config
        self.convs = convs
        self.rpn_head = model.rpn_head
        self.classifier_head = model.classifier_head
        self.mask_head = model.mask_head
        self.dtype = dtype

    def features(self, images: torch.Tensor):
        """images NHWC [B, H, W, C] -> (P2, ..., P6), NCHW channels_last."""
        def bb(name, x, stride, relu=False, then=None):
            return self.convs(f"bb/{name}", x, stride, relu, then=then and f"bb/{then}")

        c2, c3, c4, c5 = walk_resnet(images.float().contiguous(), bb, self.config.backbone)
        conv = self.convs

        def up2(x):  # nearest repeat, NHWC
            b, h, w, c = x.shape
            return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)

        p5 = conv("fpn/c5p5", c5)
        p4 = conv("fpn/c4p4", c4).add_(up2(p5))
        p3 = conv("fpn/c3p3", c3).add_(up2(p4))
        p2 = conv("fpn/c2p2", c2).add_(up2(p3))
        p2, p3, p4, p5 = (conv(f"fpn/p{i}", p) for i, p in zip((2, 3, 4, 5), (p2, p3, p4, p5)))
        p6 = p5[:, ::2, ::2, :]
        return tuple(p.to(self.dtype).contiguous().permute(0, 3, 1, 2) for p in (p2, p3, p4, p5, p6))

    def rpn(self, pyramid):
        """The shared conv per level (its own scale), then the model's 1x1
        heads in ``dtype``; concatenated over levels like ``MaskRCNN.rpn``."""
        stride = self.config.rpn_anchor_stride
        outs = []
        for lvl, p in zip(LEVELS, pyramid):
            shared = self.convs(f"rpn/shared@{lvl}", p.permute(0, 2, 3, 1), stride, relu=True)
            outs.append(self.rpn_head.heads(shared.to(self.dtype).permute(0, 3, 1, 2)))
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def classifier(self, pooled: torch.Tensor):
        """pooled [B, R, p, p, C] -> (logits, probs [B, R, K], deltas [B, R, K, 4])."""
        b, r = pooled.shape[:2]
        x = self.convs("cls/conv1", pooled.flatten(0, 1), relu=True, then="cls/conv2")  # the VALID conv = fc1
        x = self.convs("cls/conv2", x, relu=True)
        logits, probs, deltas = self.classifier_head.outputs(x.flatten(1).to(self.dtype))
        k = self.config.num_classes
        return logits.view(b, r, k), probs.view(b, r, k), deltas.view(b, r, k, 4)

    def mask(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [B, R, p, p, C] -> masks [B, R, 2p, 2p, K]."""
        b, r = pooled.shape[:2]
        x = pooled.flatten(0, 1)
        for i in range(1, 5):
            x = self.convs(f"mask/conv{i}", x, relu=True, then=f"mask/conv{i + 1}" if i < 4 else None)
        m = self.mask_head.upsample(x.to(self.dtype).permute(0, 3, 1, 2))
        return m.reshape((b, r) + m.shape[1:])


def folded_stages(model: nn.Module, folded, observe=None) -> DetectStages:
    """f32 stages over folded weights, on the model's device; ``observe(site,
    conv_input)`` sees every quantized conv's input. For a float32 model
    they compute the standard graph (folding is exact for frozen batch
    norm)."""
    dev = next(model.parameters()).device
    return DetectStages(model, FoldedConvs(folded, observe).to(dev), torch.float32)


def int8_stages(model: nn.Module, qtree) -> DetectStages:
    """int8 stages over a numpy quantized tree (the JAX package's layout),
    its tensors moved to the model's device: per-tensor int8 input
    quantization, int8 convolution with int32 accumulation, the f32
    per-channel epilogue; the rest in the model's compute dtype."""
    dev = next(model.parameters()).device
    return DetectStages(model, Int8Convs(W.qtree_to_torch(qtree)).to(dev), compute_dtype(model.config))


# -------------------------------------------------------------- calibration


def calibrate_detect(model, folded, molded, image_metas, anchors, batch: Optional[int] = None) -> Dict[str, float]:
    """Per-tensor activation scales ``max|x| / 127`` at every quantized site
    over a calibration batch: the folded f32 detect graph runs (TF32 off,
    :func:`exact_f32`) through ``forward_inference`` on the model's
    device, ``batch`` images at a time (default the config's batch).
    ``molded`` [N, H, W, C] MOLDED images, ``image_metas`` [N, meta],
    ``anchors`` [A, 4] normalized (arrays or tensors)."""
    cfg = model.config
    dev = next(model.parameters()).device
    batch = int(batch or cfg.batch_size)
    maxabs: Dict[str, torch.Tensor] = {}

    def observe(site, x):
        m = x.abs().amax().float()
        maxabs[site] = m if site not in maxabs else torch.maximum(maxabs[site], m)

    stages = folded_stages(model, folded, observe)
    molded = torch.as_tensor(molded, dtype=torch.float32)
    metas = torch.as_tensor(image_metas, dtype=torch.float32)
    anchors = torch.as_tensor(anchors).to(dev)
    rpn_std = torch.tensor(cfg.rpn_bbox_std_dev, dtype=torch.float32, device=dev)
    bbox_std = torch.tensor(cfg.bbox_std_dev, dtype=torch.float32, device=dev)
    with exact_f32(), torch.inference_mode():
        for i in range(0, len(molded), batch):
            forward_inference(stages, molded[i:i + batch].to(dev), metas[i:i + batch].to(dev), anchors,
                              rpn_std, bbox_std)
    return {site: max(float(v), 1e-12) / 127.0 for site, v in maxabs.items()}
