"""Layers that keep float32 parameters and compute in the input's dtype
(flax's ``param_dtype=float32`` with ``dtype=compute_dtype``), and frozen
batch norm with trainable scale and bias."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding
        )


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


BN_EPS = 1e-3


class FrozenBatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-3)``: running
    statistics ``mean``/``var`` are f32 buffers that never update, while
    ``scale`` (gamma) and ``bias`` (beta) are f32 parameters that train.
    Computes ``(x - mean) * (scale / sqrt(var + eps)) + bias`` in f32 and
    returns the input's dtype, as flax does: ``F.batch_norm`` in inference
    mode is that function in one kernel, with gradients for scale and bias.
    (Composing it from ``sub`` and ``addcmul`` doubled the launches and
    slowed the host-bound detect step by 15-20% on the card.)"""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False, eps=BN_EPS)
