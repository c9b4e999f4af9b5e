"""int8 weight and activation backbone (the quantized serving path).

Port of ``caesar_mrcnn_tpu/models/backbone_int8.py``: frozen batch norm
folded into each conv's ``(w, b)``, per-output-channel symmetric int8
weights, per-tensor symmetric int8 activations with scales calibrated by
max-abs, and convolutions that accumulate in int32 (``ops/quant.py``: the
kernels of ``csrc/conv_int8.cu`` on the card). The topology is one walk,
:func:`walk_resnet`, run by both the f32 folded forward (calibration, fold
tests) and the int8 forward, with a pluggable conv. The walk names, at each
conv whose output one quantized conv alone reads, that consumer
(``then=``): the int8 convs then quantize for it in the producer's
epilogue, as XLA fuses the quantizer into the conv before it in the JAX
package (``caesar_mrcnn_tpu/models/backbone_int8.py:263-267``); the f32
convs ignore it.

Folding and quantization are numpy on the JAX package's tree shape (a
``weights.state_dict_to_flax`` of the port's model), so the folded and
quantized weights equal the JAX package's bit for bit. Activations are NHWC
and contiguous; the residual stream is f32.

Pipeline::

    folded = fold_bn(variables, architecture)        # {name: (w HWIO f32, b f32)}
    scales = calibrate(folded, architecture, images) # {name: s_in}, on cuda
    qtree  = quantize(folded, scales)                # int8 weights + scales
    c2..c5 = resnet_int8(qtree, images, architecture)
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import conv2d_int8, pad_for, padded_channels, quantize_int8, xla_pads
from .backbone import BLOCK_COUNTS, max_pool_same
from .layers import BN_EPS

# conv slot -> FrozenableBatchNorm child index inside a flax Bottleneck
_BN_INDEX = {"conv1": 0, "conv2": 1, "conv3": 2, "shortcut": 3}

# conv(site, x NHWC, stride, relu, then) -> f32 NHWC, the post-BN linear
# output (ReLU applied when asked); ``then`` names the one conv that reads
# it, for which an int8 conv may return it quantized (int8 NHWC)
Conv = Callable[..., torch.Tensor]


def stage_blocks(architecture: str):
    """(block name, projects, stride) per block, per stage, as
    ``models/backbone.py::ResNet`` builds them."""
    n4 = 1 if architecture == "custom" else BLOCK_COUNTS[architecture]
    return [
        [("res2a", True, 1), ("res2b", False, 1), ("res2c", False, 1)],
        [("res3a", True, 2), ("res3b", False, 1), ("res3c", False, 1), ("res3d", False, 1)],
        [("res4a", True, 2)] + [(f"res4{chr(98 + i)}", False, 1) for i in range(n4)],
        [("res5a", True, 2), ("res5b", False, 1), ("res5c", False, 1)],
    ]


def walk_resnet(x: torch.Tensor, conv: Conv, architecture: str) -> Tuple[torch.Tensor, ...]:
    """The ResNet topology over a pluggable conv, on NHWC ``x``: the 7x7/2
    stem with its explicit 3-pad and ReLU, the 3x3/2 SAME max pool, then
    every bottleneck with its f32 residual sum. Conv names: ``conv1`` for
    the stem, ``<block>/conv{1,2,3}`` and ``<block>/shortcut``; each
    block's conv1 and conv2 name their consumer (``then``). Returns (C2,
    C3, C4, C5), NHWC."""
    x = conv("conv1", x, 2, relu=True)
    x = max_pool_same(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
    outs = []
    for blocks in stage_blocks(architecture):
        for name, project, stride in blocks:
            y = conv(f"{name}/conv1", x, stride, relu=True, then=f"{name}/conv2")
            y = conv(f"{name}/conv2", y, 1, relu=True, then=f"{name}/conv3")
            y = conv(f"{name}/conv3", y, 1)
            sc = conv(f"{name}/shortcut", x, stride) if project else x
            x = y.add_(sc).relu_()  # y is the conv's fresh output
        outs.append(x)
    return tuple(outs)


# ------------------------------------------------------------------ folding


def fold_conv_bn(conv_p, bn_p, bn_s, eps: float = BN_EPS):
    """Fold a frozen batch norm into the conv before it (numpy, f32):
    ``w' = w * gamma / sqrt(var + eps)``, ``b' = (bias - mean) * gamma /
    sqrt(var + eps) + beta``."""
    w = np.asarray(conv_p["kernel"], np.float32)
    cb = np.asarray(conv_p.get("bias", np.zeros(w.shape[-1])), np.float32)
    gamma = np.asarray(bn_p["scale"], np.float32)
    beta = np.asarray(bn_p["bias"], np.float32)
    mean = np.asarray(bn_s["mean"], np.float32)
    var = np.asarray(bn_s["var"], np.float32)
    inv = gamma / np.sqrt(var + eps)
    return w * inv, (cb - mean) * inv + beta


def quantize_conv(w: np.ndarray, b: np.ndarray, s_in: float) -> Dict[str, np.ndarray]:
    """Per-output-channel symmetric int8 weights for one conv: {w: int8
    [k, k, cin, cout], sw: f32 [cout] (weight scale times input scale, the
    int32 -> f32 factor), b: f32 [cout], s_in: f32 (the input's scale)}."""
    s_in = np.float32(s_in)
    wmax = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12)  # [cout]
    sw = (wmax / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    return {"w": wq, "sw": (sw * s_in).astype(np.float32), "b": np.asarray(b, np.float32), "s_in": s_in}


def fold_bn(variables: Dict, architecture: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{conv name: (w [k, k, cin, cout] f32, b [cout] f32)} of every backbone
    conv with its batch norm folded in. ``variables`` is a numpy flax tree
    (``weights.state_dict_to_flax``): the whole model's, whose backbone is
    under ``params/backbone``, or a bare ResNet's."""
    params = variables["params"].get("backbone", variables["params"])
    stats = variables["batch_stats"].get("backbone", variables["batch_stats"])

    def bn(block, i):
        key = f"FrozenableBatchNorm_{i}"
        return block[key]["BatchNorm_0"]

    out = {"conv1": fold_conv_bn(params["conv1"], params["bn_conv1"]["BatchNorm_0"],
                                 stats["bn_conv1"]["BatchNorm_0"])}
    for blocks in stage_blocks(architecture):
        for name, project, _ in blocks:
            for slot in ["conv1", "conv2", "conv3"] + (["shortcut"] if project else []):
                i = _BN_INDEX[slot]
                out[f"{name}/{slot}"] = fold_conv_bn(params[name][slot], bn(params[name], i), bn(stats[name], i))
    return out


# -------------------------------------------------------- convs by arithmetic


class _Site(nn.Module):
    """One conv site's tensors, as buffers."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)


class FoldedConvs(nn.Module):
    """f32 convs on folded weights: ``folded`` {site: (w HWIO, b)} numpy.
    Sites may carry an ``@level`` suffix (one weight, several inputs);
    ``observe(site, x)`` sees every conv input (calibration). ``then`` is
    ignored: every output stays f32, so calibration sees the f32 inputs."""

    def __init__(self, folded: Dict[str, Tuple[np.ndarray, np.ndarray]], observe=None):
        super().__init__()
        self.observe = observe
        self.sites = nn.ModuleDict({
            site: _Site(w=torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1), np.float32)),
                        b=torch.from_numpy(np.asarray(b, np.float32)))
            for site, (w, b) in folded.items()
        })

    def forward(self, site: str, x: torch.Tensor, stride: int = 1, relu: bool = False,
                then: Optional[str] = None) -> torch.Tensor:
        if self.observe is not None:
            self.observe(site, x)
        q = self.sites[site.split("@")[0]]
        (pt, pb), (pl, pr) = xla_pads(pad_for(site), q.w.shape[2], stride, tuple(x.shape[1:3]))
        xin = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
        y = F.conv2d(xin, q.w, stride=stride) + q.b[:, None, None]
        y = y.permute(0, 2, 3, 1)
        return (torch.relu(y) if relu else y).contiguous()


def pad_input_channels(w: torch.Tensor) -> torch.Tensor:
    """Packed int8 weights [Cout, k, k, Cin] with zero input channels up
    to :func:`~..ops.quant.padded_channels` (the stem's 3 to 16), once
    when the graph is built, so that ``quant.hopper_operands`` copies
    nothing per call; the int32 sums do not change."""
    c = w.shape[3]
    return w if c % 16 == 0 else F.pad(w, (0, padded_channels(c) - c)).contiguous()


class Int8Convs(nn.Module):
    """int8 convs on a quantized tree in the port's layout
    (``weights.qtree_to_torch``): each f32 or bf16 input quantized by its
    site's ``s_in`` (:func:`~..ops.quant.quantize_int8`; where Cin is not a
    multiple of 16, the stem's 3, with its channels padded to match weights
    padded once here), then :func:`~..ops.quant.conv2d_int8` with the
    per-channel epilogue. Given ``then``, the output comes back int8 at
    that site's ``s_in`` (the quantizer in the epilogue), and that site
    takes it as it is. Inputs are contiguous NHWC."""

    def __init__(self, qtree: Dict[str, Dict]):
        super().__init__()
        self.sites = nn.ModuleDict({site: _Site(w=q["w"], sw=q["sw"], b=q["b"]) for site, q in qtree.items()})
        self.padded = nn.ModuleDict({site: _Site(w=pad_input_channels(q["w"]))
                                     for site, q in qtree.items() if q["w"].shape[3] % 16})
        self.s_in = {site: float(q["s_in"]) for site, q in qtree.items()}

    def forward(self, site: str, x: torch.Tensor, stride: int = 1, relu: bool = False,
                then: Optional[str] = None) -> torch.Tensor:
        q = self.sites[site]
        if x.dtype == torch.int8:  # quantized for this site by the conv before it
            xq, w = x, q.w
        else:
            w = self.padded[site].w if site in self.padded else q.w
            xq = quantize_int8(x, self.s_in[site], channels=w.shape[3])
        pads = xla_pads(pad_for(site), w.shape[1], stride, tuple(x.shape[1:3]))
        return conv2d_int8(xq, w, q.sw, q.b, stride, pads, relu, None if then is None else self.s_in[then])


# ------------------------------------------------------------ forward passes


def folded_forward(folded, x: torch.Tensor, architecture: str, observe=None):
    """f32 forward through the folded weights, NHWC ``x`` -> (C2..C5), on
    ``x``'s device; ``observe(name, conv_input)`` as :class:`FoldedConvs`."""
    convs = FoldedConvs(folded, observe).to(x.device)
    return walk_resnet(x.float(), convs, architecture)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls (restored after):
    the folded graph's scales drift by ~1e-3 relative under TF32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def calibrate(folded, architecture: str, images, batch: int = 4, device="cuda") -> Dict[str, float]:
    """Per-tensor activation scales ``max|x| / 127`` of every conv input over
    ``images`` [N, H, W, C], MOLDED float inputs, in batches of ``batch`` on
    ``device`` (TF32 off, :func:`exact_f32`)."""
    maxabs: Dict[str, torch.Tensor] = {}

    def observe(name, x):
        m = x.abs().amax()
        maxabs[name] = m if name not in maxabs else torch.maximum(maxabs[name], m)

    convs = FoldedConvs(folded, observe).to(device)
    images = torch.as_tensor(np.asarray(images, np.float32))
    with exact_f32(), torch.inference_mode():
        for i in range(0, len(images), batch):
            walk_resnet(images[i:i + batch].to(device), convs, architecture)
    return {k: max(float(v), 1e-12) / 127.0 for k, v in maxabs.items()}


def quantize(folded, act_scales: Dict[str, float]) -> Dict[str, Dict[str, np.ndarray]]:
    """{name: :func:`quantize_conv` of its folded weights at its scale}."""
    return {name: quantize_conv(w, b, act_scales[name]) for name, (w, b) in folded.items()}


def resnet_int8(qtree, x: torch.Tensor, architecture: str, out_dtype: Optional[torch.dtype] = torch.bfloat16):
    """int8 forward over a numpy quantized tree, NHWC ``x`` -> (C2..C5) in
    ``out_dtype``, on ``x``'s device."""
    from ..weights import qtree_to_torch

    convs = Int8Convs(qtree_to_torch(qtree)).to(x.device)
    return tuple(c.to(out_dtype) for c in walk_resnet(x.float().contiguous(), convs, architecture))


def build_qtree(variables: Dict, architecture: str, calib_images, device="cuda"):
    """fold + calibrate + quantize in one call (numpy tree)."""
    folded = fold_bn(variables, architecture)
    return quantize(folded, calibrate(folded, architecture, calib_images, device=device))
