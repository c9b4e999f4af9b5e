"""Weights: flax variables -> the port's ``state_dict``, and seeded random
initialisation by flax's default scheme.

A flax tree is a nested dict of numpy arrays, ``{"params": ...,
"batch_stats": ...}``, as ``caesar_mrcnn_tpu.models.mask_rcnn.init_model``
or a checkpoint restore gives it. Conversions:

* conv kernels HWIO -> OIHW (the classifier's fc1 stays a 7x7 VALID conv);
* Dense kernels (in, out) -> (out, in);
* the mask deconv kernel (kh, kw, in, out) -> (in, out, kh, kw), flipped in
  both spatial axes: flax's ``ConvTranspose`` does not flip its kernel,
  ``conv_transpose2d`` does;
* frozen batch norm (eps 1e-3) -> ``scale = gamma / sqrt(var + eps)`` and
  ``shift = beta - mean * scale``, in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models import layers

BN_EPS = 1e-3

# Bottleneck batch norms in flax creation order -> port names
_BOTTLENECK_BN = {
    "FrozenableBatchNorm_0": "bn1",
    "FrozenableBatchNorm_1": "bn2",
    "FrozenableBatchNorm_2": "bn3",
    "FrozenableBatchNorm_3": "shortcut_bn",
}


def _bn(params: Mapping, stats: Mapping):
    gamma = np.asarray(params["scale"], np.float64)
    beta = np.asarray(params["bias"], np.float64)
    mean = np.asarray(stats["mean"], np.float64)
    var = np.asarray(stats["var"], np.float64)
    scale = gamma / np.sqrt(var + BN_EPS)
    return scale, beta - mean * scale


def _walk(params: Mapping, stats: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for name, p in params.items():
        if not isinstance(p, Mapping):
            continue
        key = prefix + _BOTTLENECK_BN.get(name, name)
        if "BatchNorm_0" in p:  # FrozenableBatchNorm wrapper
            scale, shift = _bn(p["BatchNorm_0"], stats[name]["BatchNorm_0"])
            out[key + ".scale"], out[key + ".shift"] = scale, shift
        elif "kernel" in p:
            k = np.asarray(p["kernel"])
            if k.ndim == 2:  # Dense
                w = k.T
            elif name == "mrcnn_mask_deconv":
                w = k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                w = k.transpose(3, 2, 0, 1)
            out[key + ".weight"] = w
            if "bias" in p:
                out[key + ".bias"] = np.asarray(p["bias"])
        else:
            _walk(p, stats.get(name, {}), key + ".", out)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a numpy flax variable tree to a ``MaskRCNN`` state_dict."""
    out: Dict[str, np.ndarray] = {}
    _walk(variables["params"], variables.get("batch_stats", {}), "", out)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        for k, v in out.items()
    }


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax defaults: lecun-normal kernels (normal truncated at 2 sigma,
    fan-in scaled), zero biases, identity batch norm (gamma 1, beta 0,
    mean 0, var 1). Modules are visited in registration order."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.FrozenBatchNorm):
                m.scale.fill_(1.0 / math.sqrt(1.0 + BN_EPS))
                m.shift.zero_()
                continue
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                continue
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
