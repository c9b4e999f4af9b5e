"""int8 quantizer and int8 convolution: the CUDA kernels and their plain
versions.

Port of the convolution closures of the JAX package's int8 serving graph,
``caesar_mrcnn_tpu/models/backbone_int8.py:270-284`` and
``models/heads_int8.py:274-287``:

* :func:`quantize_int8` is ``clip(round(x / s_in), -127, 127)`` as int8,
  one scale per tensor, dividing (not multiplying by the reciprocal) and
  rounding half to even;
* :func:`conv2d_int8` is the int32 accumulation of an NHWC int8 input
  against per-output-channel int8 weights, ``lax.conv_general_dilated(...,
  preferred_element_type=int32)``, followed by the f32 epilogue ``acc *
  sw + b`` (a product, then a sum, each rounded) and an optional ReLU.

Weights are packed ``[Cout, kh, kw, Cin]`` int8 (the reduction runs over
``(ky, kx, ci)`` in that order); activations are NHWC, contiguous: a
channels_last NCHW tensor is one ``permute(0, 2, 3, 1)`` away, without a
copy. :func:`xla_pads` and :func:`pad_for` give XLA's padding of every
site. CUDA tensors run ``csrc/conv_int8.cu`` (each launch counted on the
wrapper), CPU tensors the plain versions; nothing falls back.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from . import _kernels

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
STEM_PADS: Pads = ((3, 3), (3, 3))
QMAX = 127


# ------------------------------------------------------------------ padding


def xla_pads(padding: Union[str, Pads], k: int, stride: int, size: Tuple[int, int]) -> Pads:
    """((top, bottom), (left, right)) of a ``k`` x ``k`` window at
    ``stride`` on an input of ``size`` (H, W), as XLA pads it: explicit
    pads as given, ``"VALID"`` none, ``"SAME"`` ``total = max((ceil(n / s)
    - 1) * s + k - n, 0)`` split as ``(total // 2, total - total // 2)``."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding != "SAME":
        return tuple(tuple(int(v) for v in p) for p in padding)
    out = []
    for n in size:
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def pad_for(site: str) -> Union[str, Pads]:
    """Padding per conv site of the detect graph: the stem keeps its
    explicit 3-pixel pad (``conv1`` in the backbone's names, ``bb/conv1`` in
    the detect graph's); the classifier's fc1 is a VALID conv over the pool
    window; every other site is SAME."""
    if site in ("conv1", "bb/conv1"):
        return STEM_PADS
    if site == "cls/conv1":
        return "VALID"
    return "SAME"


def out_size(size: Tuple[int, int], k: int, stride: int, pads: Pads) -> Tuple[int, int]:
    return tuple((n + lo + hi - k) // stride + 1 for n, (lo, hi) in zip(size, pads))


# ----------------------------------------------------------------- quantizer


def quantize_int8_plain(x: torch.Tensor, s_in: float) -> torch.Tensor:
    """``clip(round(x / s_in), -127, 127)`` as int8 (any device). The scale
    is a tensor on ``x``'s device: PyTorch divides a CUDA tensor by a host
    scalar as a product with the scalar's reciprocal, and the JAX code
    divides."""
    s = torch.tensor(s_in, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -QMAX, QMAX).to(torch.int8)


_QUANT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8(x: torch.Tensor, s_in: float) -> torch.Tensor:
    """Per-tensor int8 quantization of a contiguous f32 or bf16 tensor;
    ``s_in`` is the f32 scale. CUDA tensors run the kernel of
    ``csrc/conv_int8.cu`` (one launch, counted in
    ``quantize_int8.launches``); CPU tensors the plain version."""
    if x.dtype not in _QUANT_DTYPES:
        raise TypeError(f"quantize_int8 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 takes a contiguous tensor")
    if x.device.type == "cpu":
        return quantize_int8_plain(x, s_in)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_int8: no kernel for device {x.device}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        status = _kernels.library().caesar_quantize_int8(
            x.data_ptr(), q.data_ptr(), x.numel(), _QUANT_DTYPES[x.dtype], float(s_in),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _kernels.check(status, "caesar_quantize_int8")
        quantize_int8.launches += 1
    return q


quantize_int8.launches = 0


# -------------------------------------------------------------- convolution


def _check_conv(xq, w, stride, pads, sw=None, b=None):
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv2d_int8 takes int8 input and weights, got {xq.dtype} and {w.dtype}")
    if xq.dim() != 4 or w.dim() != 4 or xq.shape[3] != w.shape[3]:
        raise ValueError(f"input NHWC {tuple(xq.shape)} and weights [Cout, kh, kw, Cin] {tuple(w.shape)}")
    if not (xq.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_int8 takes a contiguous NHWC input and contiguous packed weights")
    if w.shape[1] != w.shape[2] or stride < 1:
        raise ValueError(f"square windows and a positive stride only ({tuple(w.shape)}, stride {stride})")
    ho, wo = out_size(tuple(xq.shape[1:3]), w.shape[1], stride, pads)
    if ho < 1 or wo < 1 or min(min(p) for p in pads) < 0:
        raise ValueError(f"no output for input {tuple(xq.shape)}, window {w.shape[1]}, pads {pads}")
    for t in (sw, b):
        if t is not None and (t.dtype != torch.float32 or t.shape != (w.shape[0],) or not t.is_contiguous()):
            raise ValueError(f"scales and biases must be contiguous float32 [{w.shape[0]}]")
    if len({t.device for t in (xq, w, sw, b) if t is not None}) != 1:
        raise ValueError("conv2d_int8: tensors on different devices")
    return ho, wo


def conv2d_int8_accumulate_plain(xq: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads) -> torch.Tensor:
    """The int32 sums, NHWC [B, Ho, Wo, Cout] (any device): the int8
    tensors as f64 through ``F.conv2d``, exact because every partial sum is
    an integer below 2^53, rounded to int32 (which also absorbs the
    rounding of a non-exact algorithm that a library might pick)."""
    (pt, pb), (pl, pr) = pads
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(x, w.permute(0, 3, 1, 2).double(), stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv2d_int8_plain(xq, w, sw, b, stride: int, pads: Pads, relu: bool = False) -> torch.Tensor:
    """The plain version of :func:`conv2d_int8` (any device): the int32
    sums, then ``acc * sw + b`` in f32, a product and then a sum (each
    rounded), and an optional ReLU."""
    y = conv2d_int8_accumulate_plain(xq, w, stride, pads).float() * sw + b
    return torch.relu(y) if relu else y


def _conv_cuda(xq, w, sw, b, stride, pads, relu, ho, wo, raw: bool):
    bsz, h, wd, c = xq.shape
    cout, k = w.shape[0], w.shape[1]
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.int32 if raw else torch.float32, device=xq.device)
    # 16-byte loads of the input and the weights where every (ky, kx) tap is
    # whole 16-byte chunks; byte loads otherwise (the stem, Cin = 3)
    vec = c % 16 == 0 and xq.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    status = _kernels.library().caesar_conv2d_int8(
        xq.data_ptr(), w.data_ptr(), 0 if raw else sw.data_ptr(), 0 if raw else b.data_ptr(),
        out.data_ptr(), bsz, h, wd, c, ho, wo, cout, k, stride, pads[0][0], pads[1][0],
        int(relu), int(raw), int(vec), torch.cuda.current_stream(xq.device).cuda_stream,
    )
    _kernels.check(status, "caesar_conv2d_int8")
    conv2d_int8.launches += 1
    return out


def conv2d_int8(xq, w, sw, b, stride: int, pads: Pads, relu: bool = False) -> torch.Tensor:
    """int8 convolution with the f32 epilogue: NHWC int8 ``xq`` [B, H, W,
    Cin] against packed int8 ``w`` [Cout, k, k, Cin], then ``acc * sw[n] +
    b[n]`` (``sw``, ``b``: f32 [Cout]) and an optional ReLU, f32 NHWC [B,
    Ho, Wo, Cout]. ``pads`` is ((top, bottom), (left, right)), from
    :func:`xla_pads`. CUDA tensors run the implicit-GEMM kernel of
    ``csrc/conv_int8.cu`` (one launch, counted in ``conv2d_int8.launches``);
    CPU tensors the plain version."""
    ho, wo = _check_conv(xq, w, stride, pads, sw, b)
    if xq.device.type == "cpu":
        return conv2d_int8_plain(xq, w, sw, b, stride, pads, relu)
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv2d_int8: no kernel for device {xq.device}")
    return _conv_cuda(xq, w, sw, b, stride, pads, relu, ho, wo, raw=False)


conv2d_int8.launches = 0


def conv2d_int8_accumulate(xq: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads) -> torch.Tensor:
    """The int32 sums alone, NHWC [B, Ho, Wo, Cout]: the kernel of
    :func:`conv2d_int8` with its epilogue off on CUDA tensors (counted in
    ``conv2d_int8.launches``), the plain sums on CPU tensors. The checks on
    the card compare these; the detect graph calls :func:`conv2d_int8`."""
    ho, wo = _check_conv(xq, w, stride, pads)
    if xq.device.type == "cpu":
        return conv2d_int8_accumulate_plain(xq, w, stride, pads)
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv2d_int8: no kernel for device {xq.device}")
    return _conv_cuda(xq, w, None, None, stride, pads, False, ho, wo, raw=True)
