"""ResNet-50/101 and the small "custom" backbone, and the FPN.

Port of ``caesar_mrcnn_tpu/models/backbone.py``. Activations are NCHW
tensors in channels_last memory; module and parameter names follow the
flax tree so ``weights.flax_to_state_dict`` maps one onto the other.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, FrozenBatchNorm

# stage-4 identity-block count per architecture
BLOCK_COUNTS = {"resnet50": 5, "resnet101": 22}


def stage_widths(architecture: str):
    if architecture == "custom":
        return 16, [(16, 16, 64), (32, 32, 128), (64, 64, 256), (128, 128, 512)]
    return 64, [(64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048)]


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(padding="SAME")``: pad (total // 2, rest) with -inf.
    For a 3x3 window at stride 2 on an even input that is (0, 1)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with an optional projection shortcut; ``bn`` is the
    batch norm class (:func:`batch_norm`)."""

    def __init__(self, cin: int, filters: Tuple[int, int, int], stride: int = 1,
                 project: bool = False, bn=FrozenBatchNorm):
        super().__init__()
        f1, f2, f3 = filters
        self.conv1 = Conv2d(cin, f1, 1, stride=stride)
        self.bn1 = bn(f1)
        self.conv2 = Conv2d(f1, f2, 3, padding=1)
        self.bn2 = bn(f2)
        self.conv3 = Conv2d(f2, f3, 1)
        self.bn3 = bn(f3)
        if project:
            self.shortcut = Conv2d(cin, f3, 1, stride=stride)
            self.shortcut_bn = bn(f3)
        else:
            self.shortcut = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = x if self.shortcut is None else self.shortcut_bn(self.shortcut(x))
        return F.relu(y + sc)


def batch_norm(train_bn: bool):
    """The batch norm class of ``config.train_bn``: trainable (batch
    statistics in training) or frozen, as the JAX package's
    ``FrozenableBatchNorm``."""
    return BatchNorm if train_bn else FrozenBatchNorm


class ResNet(nn.Module):
    """Backbone producing (C2, C3, C4, C5); resnet50 | resnet101 | custom."""

    def __init__(self, architecture: str = "resnet101", in_channels: int = 3, train_bn: bool = False):
        super().__init__()
        stem, widths = stage_widths(architecture)
        n4 = 1 if architecture == "custom" else BLOCK_COUNTS[architecture]
        bn = batch_norm(train_bn)
        self.conv1 = Conv2d(in_channels, stem, 7, stride=2, padding=3)
        self.bn_conv1 = bn(stem)
        stages = [
            ["res2a", "res2b", "res2c"],
            ["res3a", "res3b", "res3c", "res3d"],
            ["res4a"] + [f"res4{chr(98 + i)}" for i in range(n4)],
            ["res5a", "res5b", "res5c"],
        ]
        self.stages = stages
        cin = stem
        for i, (names, filters) in enumerate(zip(stages, widths)):
            for j, name in enumerate(names):
                first = j == 0
                block = Bottleneck(cin, filters, stride=(1 if i == 0 else 2) if first else 1,
                                   project=first, bn=bn)
                self.add_module(name, block)
                cin = filters[2]

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn_conv1(self.conv1(x)))
        x = max_pool_same(x)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)


class FPN(nn.Module):
    """Top-down pyramid P2..P6; P6 is P5 subsampled at stride 2."""

    def __init__(self, in_channels: Tuple[int, int, int, int], channels: int = 256):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        self.fpn_c5p5 = Conv2d(c5, channels, 1)
        self.fpn_c4p4 = Conv2d(c4, channels, 1)
        self.fpn_c3p3 = Conv2d(c3, channels, 1)
        self.fpn_c2p2 = Conv2d(c2, channels, 1)
        for lvl in (2, 3, 4, 5):
            self.add_module(f"fpn_p{lvl}", Conv2d(channels, channels, 3, padding=1))

    def forward(self, c2, c3, c4, c5):
        def up2(x):  # nearest repeat, as jnp.repeat twice
            return F.interpolate(x, scale_factor=2, mode="nearest")

        p5 = self.fpn_c5p5(c5)
        p4 = up2(p5) + self.fpn_c4p4(c4)
        p3 = up2(p4) + self.fpn_c3p3(c3)
        p2 = up2(p3) + self.fpn_c2p2(c2)
        p2 = self.fpn_p2(p2)
        p3 = self.fpn_p3(p3)
        p4 = self.fpn_p4(p4)
        p5 = self.fpn_p5(p5)
        return p2, p3, p4, p5, p5[:, :, ::2, ::2]
