"""Frozen batch norms folded into their convolutions, and the folded
convolution with its bias, residual and ReLU in one epilogue: the detect
path's conv -> batch norm -> (add) -> ReLU chains as one convolution each.

* :func:`fold_conv_bn` folds a table of (conv, batch norm) pairs in one
  call, on every forward (a replay of a captured graph folds the live
  parameters): with ``inv = scale / sqrt(var + eps)`` per output channel,
  ``w' = w * inv`` and ``b' = (bias - mean) * inv + shift``, in f32, each
  operation correctly rounded once, then cast to the compute dtype: the
  kernel and the plain version agree bit for bit. The weights come out
  channels_last (OHWI memory), as the activations are.
  The operator ``caesar::fold_conv_bn`` (``library.py``) runs
  ``csrc/fold_conv_bn.cu`` for CUDA tensors (one launch for up to 128
  pairs, counted in ``fold_conv_bn.launches``) and :func:`fold_conv_bn_plain`
  for CPU tensors, the tests' oracle.
* :func:`conv_bias_relu` is ``relu(conv(x, w) + b [+ z])``, the operator
  ``caesar::conv_bias_relu``: cuDNN's fused epilogue on CUDA
  (``cudnn_convolution_relu``, ``cudnn_convolution_add_relu``), the plain
  convolution, add and ReLU on the CPU. Being an operator of its own, it
  has a fake implementation, which ``torch.export`` needs and ATen's
  fused convolutions lack.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import library

MAX_PAIRS = 128  # a launch's table (csrc/fold_conv_bn.cu kMaxPairs)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_layout(weight_shapes: Sequence[Sequence[int]]) -> Tuple[List[int], List[int], int, int]:
    """(weight offsets, bias offsets, weight total, bias total), in
    elements, of the flat outputs of pairs whose conv weights have
    ``weight_shapes`` [cout, cin, k, k]: each pair's end to end. (Every
    ResNet and mask-head pair has a multiple of 8 weights and of 8
    channels, so each view starts on a 16-byte boundary.)"""
    w_off, b_off, nw, nb = [], [], 0, 0
    for cout, cin, kh, kw in weight_shapes:
        w_off.append(nw)
        b_off.append(nb)
        nw += cout * cin * kh * kw
        nb += cout
    return w_off, b_off, nw, nb


def fold_conv_bn_plain(weights, biases, scales, shifts, means, variances, eps: float,
                       dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold of every pair into two flat tensors of ``dtype`` (weights
    OHWI, then biases, at :func:`fold_layout`'s offsets): the arithmetic
    of the CUDA kernel."""
    w_off, b_off, nw, nb = fold_layout([w.shape for w in weights])
    flat_w = weights[0].new_empty(nw, dtype=dtype)
    flat_b = weights[0].new_empty(nb, dtype=dtype)
    # the square root correctly rounded, as the kernel's sqrtf: taken in f64
    # and rounded once to f32 (ATen's vectorised f32 sqrt on the CPU can be
    # an ulp off)
    inv = [s / torch.sqrt((v + eps).double()).float() for s, v in zip(scales, variances)]
    folded = [(b - m) * i + sh for b, m, i, sh in zip(biases, means, inv, shifts)]
    for j, w in enumerate(weights):
        n = w.numel()
        flat_w[w_off[j]:w_off[j] + n] = (w * inv[j].view(-1, 1, 1, 1)).permute(0, 2, 3, 1).reshape(-1).to(dtype)
        flat_b[b_off[j]:b_off[j] + w.shape[0]] = folded[j].to(dtype)
    return flat_w, flat_b


def fold_conv_bn(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                 shifts: Sequence[torch.Tensor], means: Sequence[torch.Tensor], variances: Sequence[torch.Tensor],
                 eps: float, dtype: torch.dtype) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Fold each (conv, batch norm) pair; returns its ``(w', b')``: ``w'``
    [cout, cin, k, k] channels_last and ``b'`` [cout], both of ``dtype``
    (float32 or bfloat16), views of two flat tensors.

    Args:
      weights: f32 conv weights [cout, cin, k, k] (square kernels).
      biases: the convs' f32 biases [cout].
      scales, shifts, means, variances: each batch norm's f32 gamma, beta,
        running mean and running variance [cout].
      eps: the batch norm's epsilon.
    """
    n = len(weights)
    if not 0 < n <= MAX_PAIRS or any(len(a) != n for a in (biases, scales, shifts, means, variances)):
        raise ValueError(f"fold_conv_bn takes 1 to {MAX_PAIRS} weights, and one bias, scale, shift, mean and "
                         "variance a weight")
    if dtype not in DTYPES:
        raise TypeError(f"fold_conv_bn folds to float32 or bfloat16, got {dtype}")
    device = weights[0].device
    for j, w in enumerate(weights):
        if w.dim() != 4 or w.shape[2] != w.shape[3]:
            raise ValueError(f"pair {j}: a square conv weight [cout, cin, k, k], got {tuple(w.shape)}")
        vectors = (biases[j], scales[j], shifts[j], means[j], variances[j])
        if any(v.shape != (w.shape[0],) for v in vectors):
            raise ValueError(f"pair {j}: bias and batch norm vectors of {w.shape[0]} channels")
        if any(t.dtype != torch.float32 or t.device != device for t in (w,) + vectors):
            raise TypeError(f"pair {j}: float32 tensors on {device}")
    flat_w, flat_b = library.ops.fold_conv_bn(
        [w.contiguous() for w in weights], [b.contiguous() for b in biases], [s.contiguous() for s in scales],
        [s.contiguous() for s in shifts], [m.contiguous() for m in means], [v.contiguous() for v in variances],
        float(eps), dtype)
    w_off, b_off, _, _ = fold_layout([w.shape for w in weights])
    out = []
    for w, wo, bo in zip(weights, w_off, b_off):
        cout, cin, k, _ = w.shape
        wf = flat_w[wo:wo + w.numel()].view(cout, k, k, cin).permute(0, 3, 1, 2)
        out.append((wf, flat_b[bo:bo + cout]))
    return out


fold_conv_bn.launches = 0


def conv_bias_relu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, z: Optional[torch.Tensor],
                         stride: int, padding: int) -> torch.Tensor:
    """``relu(conv(x, w) + b [+ z])``: the convolution with its bias, then
    the residual, then the ReLU, channels_last."""
    y = F.conv2d(x, w, b, stride, padding)
    if z is not None:
        y = y + z
    return F.relu(y).contiguous(memory_format=torch.channels_last)


def conv_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, z: Optional[torch.Tensor] = None,
                   stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``relu(conv(x, w) + b [+ z])`` on NCHW tensors of one dtype, in one
    cuDNN call on CUDA; ``z`` (the residual) has the output's shape."""
    if x.dim() != 4 or w.dim() != 4 or b.shape != (w.shape[0],):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not (x.dtype == w.dtype == b.dtype and (z is None or z.dtype == x.dtype)):
        raise TypeError("conv_bias_relu takes x, w, b (and z) of one dtype")
    return library.ops.conv_bias_relu(x, w, b, z, int(stride), int(padding))
