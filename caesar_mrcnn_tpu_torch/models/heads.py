"""FPN classifier and mask heads (port of ``caesar_mrcnn_tpu/models/heads.py``).
ROIs are folded into the batch axis; pooled features arrive NHWC
``[R, pool, pool, C]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import batch_norm
from .layers import Conv2d, ConvTranspose2d, Linear


class ClassifierHead(nn.Module):
    """ROI features -> (class logits, probs, per-class bbox deltas), all f32."""

    def __init__(self, num_classes: int, pool_size: int = 7, fc_size: int = 1024,
                 in_channels: int = 256, train_bn: bool = False):
        super().__init__()
        self.num_classes = num_classes
        bn = batch_norm(train_bn)
        # the first FC is a VALID conv over the whole pool window
        self.mrcnn_class_conv1 = Conv2d(in_channels, fc_size, pool_size)
        self.mrcnn_class_bn1 = bn(fc_size)
        self.mrcnn_class_conv2 = Conv2d(fc_size, fc_size, 1)
        self.mrcnn_class_bn2 = bn(fc_size)
        self.mrcnn_class_logits = Linear(fc_size, num_classes)
        self.mrcnn_bbox_fc = Linear(fc_size, num_classes * 4)

    @staticmethod
    def _as_linear(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        """A conv whose window covers its whole NHWC input, as one matrix
        product: [R, p, p, C] -> [R, out]. The weight keeps its OIHW
        shape (the flax bridge's); it is read in (O, H, W, I) order to
        match the input's flatten order. cuDNN's weight gradient of the 7x7
        VALID conv took 454 ms per train step on the card."""
        w = conv.weight.permute(0, 2, 3, 1).reshape(conv.weight.shape[0], -1)
        return F.linear(x.reshape(x.shape[0], -1), w.to(x.dtype), conv.bias.to(x.dtype))

    def forward(self, x: torch.Tensor):
        x = F.relu(self.mrcnn_class_bn1(self._as_linear(self.mrcnn_class_conv1, x)))
        return self.outputs(F.relu(self.mrcnn_class_bn2(self._as_linear(self.mrcnn_class_conv2, x))))

    def outputs(self, shared: torch.Tensor):
        """The class-logit and box denses on the shared [R, fc] features."""
        logits = self.mrcnn_class_logits(shared).float()
        bbox = self.mrcnn_bbox_fc(shared).float().reshape(-1, self.num_classes, 4)
        return logits, torch.softmax(logits, dim=-1), bbox


class MaskHead(nn.Module):
    """ROI features -> per-class sigmoid masks NHWC [R, 2p, 2p, classes], f32."""

    def __init__(self, num_classes: int, in_channels: int = 256, train_bn: bool = False):
        super().__init__()
        cin = in_channels
        bn = batch_norm(train_bn)
        for i in range(1, 5):
            self.add_module(f"mrcnn_mask_conv{i}", Conv2d(cin, 256, 3, padding=1))
            self.add_module(f"mrcnn_mask_bn{i}", bn(256))
            cin = 256
        self.mrcnn_mask_deconv = ConvTranspose2d(256, 256, 2, stride=2)
        self.mrcnn_mask = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(1, 5):
            conv = getattr(self, f"mrcnn_mask_conv{i}")
            bn = getattr(self, f"mrcnn_mask_bn{i}")
            x = F.relu(bn(conv(x)))
        return self.upsample(x)

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        """The deconv and the per-class 1x1 on [R, 256, p, p] (NCHW)."""
        x = F.relu(self.mrcnn_mask_deconv(x))
        return torch.sigmoid(self.mrcnn_mask(x).float()).permute(0, 2, 3, 1)
