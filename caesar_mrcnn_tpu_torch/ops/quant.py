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
  sw + b`` (a product, then a sum, each rounded) and an optional ReLU;
  given the next site's scale ``s_next``, it also applies that site's
  quantizer and returns int8 (what XLA fuses into the convolution,
  ``backbone_int8.py:263-267``).

Weights are packed ``[Cout, kh, kw, Cin]`` int8 (the reduction runs over
``(ky, kx, ci)`` in that order); activations are NHWC, contiguous: a
channels_last NCHW tensor is one ``permute(0, 2, 3, 1)`` away, without a
copy. :func:`xla_pads` and :func:`pad_for` give XLA's padding of every
site. The wrappers check their inputs and call the operators
``caesar::quantize_int8`` and ``caesar::conv2d_int8`` (``library.py``):
CUDA tensors run ``csrc/conv_int8.cu`` (each launch counted on the
wrapper), CPU tensors the plain versions; nothing falls back. The
convolution has one kernel on the card, the Hopper kernel (wgmma, a TMA
and cp.async ring, split-K), which takes 16 | Cin and 16-byte aligned
tensors: :func:`hopper_operands` readies any other operands for it, and
:func:`conv_plan` picks its tile width and split.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import library

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


def _flat(pads: Pads) -> List[int]:
    """((top, bottom), (left, right)) as the operator takes it: [top,
    bottom, left, right]."""
    return [int(v) for p in pads for v in p]


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


def quantize_int8(x: torch.Tensor, s_in: float, channels: Optional[int] = None) -> torch.Tensor:
    """Per-tensor int8 quantization of a contiguous f32 or bf16 tensor;
    ``s_in`` is the f32 scale. ``channels`` (a multiple of 16, at least the
    last dimension) pads the last dimension with zeros: the stem's NHWC
    image leaves with 16 channels. Through ``caesar::quantize_int8``: CUDA
    tensors run a kernel of ``csrc/conv_int8.cu`` (one launch, counted in
    ``quantize_int8.launches``), CPU tensors the plain version."""
    if x.dtype not in _QUANT_DTYPES:
        raise TypeError(f"quantize_int8 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 takes a contiguous tensor")
    c = x.shape[-1] if x.dim() else 1
    pad = channels is not None and channels != c
    if pad and (channels % 16 or channels < c or x.dim() == 0):
        raise ValueError(f"quantize_int8 pads {c} channels to a multiple of 16 at least as large, not {channels}")
    return library.ops.quantize_int8(x, float(s_in), channels)


quantize_int8.launches = 0


def padded_channels(c: int) -> int:
    """Input channels as the Hopper kernel takes them: a multiple of 16."""
    return -(-c // 16) * 16


def hopper_operands(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC int8 ``x`` and packed int8 ``w`` [Cout, k, k, Cin] as the Hopper
    kernel takes them: Cin zero-padded to :func:`padded_channels` (the
    padded taps add 0 x w products only), and each copied into fresh
    storage where its data does not start on a 16-byte boundary. Where
    both already qualify, the same tensors, no copy: so at every serving
    site (the stem's image leaves its quantizer with 16 channels, and its
    weights are padded once, ``backbone_int8.pad_input_channels``)."""
    pad = padded_channels(x.shape[-1]) - x.shape[-1]
    if pad:
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, pad))
    if x.data_ptr() % 16:
        x = x.clone()
    if w.data_ptr() % 16:
        w = w.clone()
    return x, w


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


def conv2d_int8_plain(xq, w, sw, b, stride: int, pads: Pads, relu: bool = False,
                      s_next: Optional[float] = None) -> torch.Tensor:
    """The plain version of :func:`conv2d_int8` (any device): the int32
    sums, then ``acc * sw + b`` in f32, a product and then a sum (each
    rounded), and an optional ReLU; with ``s_next``, that value through
    :func:`quantize_int8_plain`."""
    y = conv2d_int8_accumulate_plain(xq, w, stride, pads).float() * sw + b
    y = torch.relu(y) if relu else y
    return y if s_next is None else quantize_int8_plain(y, s_next)


# ------------------------------------------------------------------ plan

SMS = 132  # streaming multiprocessors of an H100 SXM: the plan's default card
TILE_M, TILE_K = 128, 128  # the Hopper kernel's rows per block and bytes of K per stage (hop::kBM, hop::kBK)
TILE_N = (64, 128, 256)
MAX_SPLITS = 8
_MODES = {"raw": 0, "f32": 1, "q8": 2}
_OUT_DTYPES = {"raw": torch.int32, "f32": torch.float32, "q8": torch.int8}


class ConvPlan(NamedTuple):
    """How one convolution runs on the card: the Hopper kernel with ``bn``
    output channels per block and K split ``splits`` ways."""

    bn: int
    splits: int


@functools.lru_cache(maxsize=4096)
def _tiles(m: int, n: int, kdim: int, sms: int) -> Tuple[int, int]:
    """(bn, splits) of the Hopper kernel for an M x N x K product: the pair
    with the fewest waves of blocks over the card's ``sms`` SMs, each wave
    costing its blocks' stages of K (a stage's time taken as bn + 64, the
    B tile plus the fixed A tile and latency) and its epilogue (three times
    as long with a split: the partial tiles written and read back). A split
    only where each share keeps at least two stages; fewer splits and wider
    tiles win ties."""
    nk = -(-kdim // TILE_K)
    mt = -(-m // TILE_M)
    best = None
    for bn in TILE_N:
        if bn > 64 and n <= bn // 2:
            continue  # a tile at most twice the channels
        tiles = mt * -(-n // bn)
        for splits in range(1, MAX_SPLITS + 1):
            kps = -(-nk // splits)
            if -(-nk // kps) != splits or (splits > 1 and kps < 2):
                continue
            waves = -(-tiles * splits // sms)
            cost = waves * (kps + (3 if splits > 1 else 1)) * (bn + 64)
            key = (cost, splits, -bn)
            if best is None or key < best[0]:
                best = (key, bn, splits)
    return best[1], best[2]


def conv_plan(m: int, n: int, kdim: int, sms: int = SMS) -> ConvPlan:
    """The tile width and split of one convolution (M x N x K, K with Cin
    padded as :func:`hopper_operands` pads it) on a card of ``sms`` SMs."""
    return ConvPlan(*_tiles(m, n, kdim, sms))


def conv2d_int8(xq, w, sw, b, stride: int, pads: Pads, relu: bool = False,
                s_next: Optional[float] = None) -> torch.Tensor:
    """int8 convolution with the f32 epilogue: NHWC int8 ``xq`` [B, H, W,
    Cin] against packed int8 ``w`` [Cout, k, k, Cin], then ``acc * sw[n] +
    b[n]`` (``sw``, ``b``: f32 [Cout]) and an optional ReLU, f32 NHWC [B,
    Ho, Wo, Cout]; with ``s_next`` (the scale of the one convolution that
    reads this output) that value quantized at ``s_next``, int8 NHWC.
    ``pads`` is ((top, bottom), (left, right)), from :func:`xla_pads`.
    Through ``caesar::conv2d_int8``: CUDA tensors run the Hopper kernel of
    ``csrc/conv_int8.cu`` on :func:`hopper_operands`, one launch, counted
    in ``conv2d_int8.launches``; CPU tensors the plain version."""
    if sw is None or b is None:
        raise ValueError("conv2d_int8 takes its scales and biases (conv2d_int8_accumulate gives the sums alone)")
    _check_conv(xq, w, stride, pads, sw, b)
    s_next = None if s_next is None else float(s_next)
    return library.ops.conv2d_int8(xq, w, sw, b, stride, _flat(pads), relu, s_next)


conv2d_int8.launches = 0
# The same count under the kernel's name, kept only because the benchmark's
# int8 driver reads it (``conv2d_int8.wgmma`` in its launch log).
conv2d_int8.route_launches = {"wgmma": 0}


def conv2d_int8_accumulate(xq: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads) -> torch.Tensor:
    """The int32 sums alone, NHWC [B, Ho, Wo, Cout]: the kernel of
    :func:`conv2d_int8` with its epilogue off on CUDA tensors (counted as
    it counts), the plain sums on CPU tensors. The checks on the card
    compare these; the detect graph calls :func:`conv2d_int8`."""
    _check_conv(xq, w, stride, pads)
    return library.ops.conv2d_int8(xq, w, None, None, stride, _flat(pads), False, None)
