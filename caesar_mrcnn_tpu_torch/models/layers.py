"""Layers that keep float32 parameters and compute in the input's dtype
(flax's ``param_dtype=float32`` with ``dtype=compute_dtype``), frozen batch
norm with trainable scale and bias, the trainable batch norm of
``train_bn=True``, and the rule by which a conv and the frozen batch norm
after it run as one folded convolution (:func:`folds`, :func:`fold`)."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import telemetry
from ..ops.fold import fold_conv_bn
from ..parallel.dist import all_reduce_sum


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


# flax BatchNorm's momentum: running := MOMENTUM * running + (1 - MOMENTUM) * batch
BN_MOMENTUM = 0.99


class BatchNorm(FrozenBatchNorm):
    """The batch norm of ``train_bn=True``: flax ``BatchNorm(momentum=0.99,
    epsilon=1e-3)`` with ``use_running_average=not train``.

    Outside a :func:`batch_statistics` block it is :class:`FrozenBatchNorm`
    (the running statistics: detect, export, the int8 graph). Inside one it
    normalizes with the batch's statistics, computed as flax computes them:
    in f32, over every axis but the channels (dim 1), the biased variance
    ``max(0, mean(x^2) - mean^2)`` (``use_fast_variance``); over the global
    batch when the block has a process group, the ``(sum x, sum x^2)`` of
    every rank summed by :func:`~..parallel.dist.all_reduce_sum`, whose
    backward sums the incoming gradients over the ranks, so that each
    rank's input gradient has the other ranks' terms through the mean and
    the variance. It records the detached ``(mean, var)`` in the block's
    dict and leaves the running statistics alone: the train step commits
    them (:func:`commit_batch_stats`), and nothing that merely runs a
    forward moves them. ``F.batch_norm(training=True)`` would fold in the
    unbiased variance, with a momentum that means the opposite of flax's."""

    def __init__(self, channels: int):
        super().__init__(channels)
        self.sink: Optional[Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]] = None
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sink is None:
            return super().forward(x)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [d for d in range(x.dim()) if d != 1]
        sums = torch.cat([x32.sum(dims), (x32 * x32).sum(dims)])
        count = x32.numel() // x32.shape[1]
        if self.group is not None:
            sums = all_reduce_sum(sums, self.group)
            count *= dist.get_world_size(self.group)
        mean, mean_sq = (sums / count).chunk(2)
        var = (mean_sq - mean * mean).clamp_min(0.0)
        self.sink[self] = (mean.detach(), var.detach())
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return ((x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(x.dtype)


@contextlib.contextmanager
def batch_statistics(model: nn.Module, group=None) -> Iterator[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """Within the block every :class:`BatchNorm` of ``model`` normalizes
    with its batch's statistics (the global batch's with ``group``); the
    dict it yields holds, once the forward has run, each layer's ``(mean,
    var)`` by module name."""
    layers = {m: name for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    seen: Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]] = {}
    named: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for m in layers:
        m.sink, m.group = seen, group
    try:
        yield named
    finally:
        for m in layers:
            m.sink = m.group = None
        named.update((layers[m], stats) for m, stats in seen.items())


@torch.no_grad()
def commit_batch_stats(model: nn.Module, stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """flax's update of the running statistics, in f32:
    ``running = 0.99 * running + 0.01 * batch`` for each layer of
    ``stats`` (a :func:`batch_statistics` dict)."""
    if not stats:
        return
    mods = [model.get_submodule(name) for name in stats]
    running = [m.mean for m in mods] + [m.var for m in mods]
    batch = [s[0] for s in stats.values()] + [s[1] for s in stats.values()]
    torch._foreach_mul_(running, BN_MOMENTUM)
    torch._foreach_add_(running, torch._foreach_mul(batch, 1.0 - BN_MOMENTUM))


def folds(pairs: Sequence[Tuple[nn.Module, nn.Module]]) -> bool:
    """Whether (conv, batch norm) pairs run folded (:func:`fold`): with
    gradients off (the scale, shift and weights then need none), every
    batch norm frozen (a :class:`FrozenBatchNorm`, or a :class:`BatchNorm`
    outside :func:`batch_statistics`) and in eval mode (``Module.eval()``,
    which ``inference/detector.py::Detector`` sets), and no forward hook on
    any of the modules, whose calls the folded path skips
    (``models/introspection.py`` hooks every module). A training run's
    validation pass, under ``no_grad`` with the model in train mode, so
    keeps the arithmetic of the training forward it evaluates."""
    if torch.is_grad_enabled():
        return False
    return all(not bn.training and getattr(bn, "sink", None) is None
               and not any(m._forward_hooks or m._forward_pre_hooks for m in (conv, bn))
               for conv, bn in pairs)


def fold(pairs: Sequence[Tuple[nn.Module, nn.Module]], dtype: torch.dtype) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each pair's batch norm folded into its conv, ``(w', b')`` in
    ``dtype`` (``ops/fold.py::fold_conv_bn``, one operator call for all
    pairs, on the live parameters). Counts the pairs in
    ``model.conv_bn_folded`` while a recording is open."""
    convs, bns = zip(*pairs)
    out = fold_conv_bn([c.weight for c in convs], [c.bias for c in convs], [b.scale for b in bns],
                       [b.bias for b in bns], [b.mean for b in bns], [b.var for b in bns], BN_EPS, dtype)
    telemetry.count("model.conv_bn_folded", len(pairs))
    return out
