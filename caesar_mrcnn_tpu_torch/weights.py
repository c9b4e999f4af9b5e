"""Weights: the bridge between flax variables and the port's ``state_dict``
(both ways), the flax path of every port tensor, and seeded random
initialisation by flax's default scheme.

A flax tree is a nested dict of numpy arrays, ``{"params": ...,
"batch_stats": ...}``, as ``caesar_mrcnn_tpu.models.mask_rcnn.init_model``
or a checkpoint restore gives it. Conversions:

* conv kernels HWIO <-> OIHW (the classifier's fc1 stays a 7x7 VALID conv);
* Dense kernels (in, out) <-> (out, in);
* the mask deconv kernel (kh, kw, in, out) <-> (in, out, kh, kw), flipped
  in both spatial axes: flax's ``ConvTranspose`` does not flip its kernel,
  ``conv_transpose2d`` does;
* frozen batch norm: params ``scale``/``bias`` and batch stats
  ``mean``/``var`` keep their names and values.

:func:`qtree_to_torch` carries the int8 serving graph's quantized tree
(``models/heads_int8.py``, the JAX package's layout) to the port's packed
layout.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models import layers

# Bottleneck batch norms in flax creation order -> port names
_BOTTLENECK_BN = {
    "FrozenableBatchNorm_0": "bn1",
    "FrozenableBatchNorm_1": "bn2",
    "FrozenableBatchNorm_2": "bn3",
    "FrozenableBatchNorm_3": "shortcut_bn",
}
_PORT_BN = {v: k for k, v in _BOTTLENECK_BN.items()}
_BN_LEAVES = {"scale": "params", "bias": "params", "mean": "batch_stats", "var": "batch_stats"}
# port batch norm modules: bn1..bn3, shortcut_bn, bn_conv1, mrcnn_*_bn<i>
_BN_NAME = re.compile(r"(^|_)bn(\d|_|$)")
_DECONV = "mrcnn_mask_deconv"


def _walk(params: Mapping, stats: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for name, p in params.items():
        if not isinstance(p, Mapping):
            continue
        key = prefix + _BOTTLENECK_BN.get(name, name)
        if "BatchNorm_0" in p:  # FrozenableBatchNorm wrapper
            bn_stats = stats.get(name, {}).get("BatchNorm_0", {})  # absent from a partial tree
            for leaf, value in {**p["BatchNorm_0"], **bn_stats}.items():
                out[f"{key}.{leaf}"] = np.asarray(value)
        elif "kernel" in p:
            k = np.asarray(p["kernel"])
            if k.ndim == 2:  # Dense
                w = k.T
            elif name == _DECONV:
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


def flax_path(name: str) -> Tuple[str, str]:
    """(collection, flax path) of a port state_dict key, e.g.
    ``backbone.res2a.bn1.scale`` -> ``("params",
    "backbone/res2a/FrozenableBatchNorm_0/BatchNorm_0/scale")`` and
    ``fpn.fpn_p2.weight`` -> ``("params", "fpn/fpn_p2/kernel")``. The
    paths are the ones the JAX trainer's stage and decay regexes read."""
    *mods, leaf = name.split(".")
    is_bn = _BN_NAME.search(mods[-1]) is not None
    mods = [_PORT_BN.get(m, m) for m in mods]
    if is_bn:
        return _BN_LEAVES[leaf], "/".join(mods + ["BatchNorm_0", leaf])
    return "params", "/".join(mods + ["kernel" if leaf == "weight" else leaf])


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`flax_to_state_dict`: a numpy flax variable tree."""
    tree: Dict = {}
    for name, t in state_dict.items():
        v = t.detach().cpu().numpy()
        collection, path = flax_path(name)
        parts = path.split("/")
        if parts[-1] == "kernel":
            if v.ndim == 2:
                v = v.T
            elif parts[-2] == _DECONV:
                v = v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                v = v.transpose(2, 3, 1, 0)
        node = tree.setdefault(collection, {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(v)
    return tree


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax defaults: lecun-normal kernels (normal truncated at 2 sigma,
    fan-in scaled), zero biases, identity batch norm (gamma 1, beta 0,
    mean 0, var 1). Modules are visited in registration order."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.FrozenBatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
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


def qtree_to_torch(qtree: Mapping) -> Dict[str, Dict]:
    """The JAX package's quantized tree (numpy: ``w`` int8 HWIO [k, k, cin,
    cout], ``sw`` and ``b`` f32 [cout], ``s_in`` f32) in the port's layout:
    ``w`` packed int8 [cout, k, k, cin], contiguous; ``sw``, ``b`` f32
    tensors; ``s_in`` a Python float (its f32 value)."""
    out = {}
    for site, q in qtree.items():
        w = np.asarray(q["w"])
        if w.dtype != np.int8:
            raise TypeError(f"{site}: int8 weights expected, got {w.dtype}")
        out[site] = {
            "w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2))),
            "sw": torch.from_numpy(np.asarray(q["sw"], np.float32).copy()),
            "b": torch.from_numpy(np.asarray(q["b"], np.float32).copy()),
            "s_in": float(np.float32(q["s_in"])),
        }
    return out
