"""Layers that keep float32 parameters and compute in the input's dtype
(flax's ``param_dtype=float32`` with ``dtype=compute_dtype``), and frozen
batch norm as a fixed per-channel affine map."""

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


class FrozenBatchNorm(nn.Module):
    """Inference batch norm folded into ``x * scale + shift`` (f32 buffers:
    ``scale = gamma / sqrt(var + eps)``, ``shift = beta - mean * scale``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("shift", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        return x * self.scale.to(x.dtype).view(shape) + self.shift.to(x.dtype).view(shape)
