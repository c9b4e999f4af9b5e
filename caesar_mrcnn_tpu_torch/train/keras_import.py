"""Keras/Matterport ``.h5`` weight interop (port of
``caesar_mrcnn_tpu/train/keras_import.py`` on numpy trees).

The published caesar-mrcnn weights are Keras ``save_weights`` files: root
(or ``model_weights`` group) attr ``layer_names``; each layer group has
attr ``weight_names`` like ``b"conv1/kernel:0"`` with datasets under those
paths; the RPN is a nested ``rpn_model`` group. This module maps that
layout onto the flax variable names both ways (the names the port's
``weights.flax_path`` gives every tensor), so such a file can seed the
port and the port's weights can be written back:

* ``conv1``/``bn_conv1`` -> ``backbone/conv1``, ``backbone/bn_conv1``
* ``res{S}{b}_branch2a|2b|2c|1`` -> ``backbone/res{S}{b}/conv1|conv2|conv3|shortcut``
* ``bn{S}{b}_branch2a|2b|2c|1`` -> ``backbone/res{S}{b}/FrozenableBatchNorm_0..3``
* ``fpn_*`` -> ``fpn/*`` ; ``rpn_model/rpn_*`` -> ``rpn_head/rpn_*``
* ``mrcnn_class_*``/``mrcnn_bbox_fc`` -> ``classifier_head/*`` ;
  ``mrcnn_mask*`` -> ``mask_head/*``

Keras Conv2D kernels are [kh, kw, cin, cout] and Dense [in, out], as in
flax. ``mrcnn_mask_deconv`` is the exception: Keras ``Conv2DTranspose``
stores [kh, kw, cout, cin] and flax ``ConvTranspose`` [kh, kw, cin, cout],
so axes 2 and 3 swap here; ``weights.flax_to_state_dict`` then flips the
flax kernel spatially for ``conv_transpose2d``.

``h5py`` is imported only by the functions that read or write a file.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

_BRANCH_TO_CONV = {"2a": "conv1", "2b": "conv2", "2c": "conv3", "1": "shortcut"}
_BRANCH_TO_BN = {
    "2a": "FrozenableBatchNorm_0",
    "2b": "FrozenableBatchNorm_1",
    "2c": "FrozenableBatchNorm_2",
    "1": "FrozenableBatchNorm_3",
}
_CONV_TO_BRANCH = {v: k for k, v in _BRANCH_TO_CONV.items()}
_BN_TO_BRANCH = {v: k for k, v in _BRANCH_TO_BN.items()}

# keras weight suffix -> (collection, leaf name)
_WEIGHT_MAP = {
    "kernel": ("params", "kernel"),
    "bias": ("params", "bias"),
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}
_LEAF_MAP = {  # inverse, keyed by (collection, leaf)
    ("params", "scale"): "gamma",
    ("batch_stats", "mean"): "moving_mean",
    ("batch_stats", "var"): "moving_variance",
}


def _module_path(layer: str) -> Optional[List[str]]:
    """Reference layer name -> module path inside the variable tree
    (without collection or leaf), or None for unknown layers."""
    m = re.fullmatch(r"res(\d)([a-z])_branch(2[abc]|1)", layer)
    if m:
        return ["backbone", f"res{m.group(1)}{m.group(2)}", _BRANCH_TO_CONV[m.group(3)]]
    m = re.fullmatch(r"bn(\d)([a-z])_branch(2[abc]|1)", layer)
    if m:
        return ["backbone", f"res{m.group(1)}{m.group(2)}", _BRANCH_TO_BN[m.group(3)], "BatchNorm_0"]
    if layer == "conv1":
        return ["backbone", "conv1"]
    if layer == "bn_conv1":
        return ["backbone", "bn_conv1", "BatchNorm_0"]
    if layer.startswith("fpn_"):
        return ["fpn", layer]
    if layer.startswith("rpn_"):  # rpn_conv_shared / rpn_class_raw / rpn_bbox_pred
        return ["rpn_head", layer]
    if layer.startswith("mrcnn_class") or layer == "mrcnn_bbox_fc":
        head = ["classifier_head", layer]
        if "bn" in layer:
            head.append("BatchNorm_0")
        return head
    if layer.startswith("mrcnn_mask"):
        head = ["mask_head", layer]
        if "_bn" in layer:
            head.append("BatchNorm_0")
        return head
    return None


def _keras_layer(path: Sequence[str]) -> Optional[str]:
    """Module path -> reference layer name (inverse of _module_path)."""
    parts = list(path)
    if parts[0] == "backbone":
        if parts[1] == "conv1":
            return "conv1"
        if parts[1] == "bn_conv1":
            return "bn_conv1"
        m = re.fullmatch(r"res(\d)([a-z])", parts[1])
        if m and len(parts) >= 3:
            if parts[2] in _CONV_TO_BRANCH:
                return f"res{m.group(1)}{m.group(2)}_branch{_CONV_TO_BRANCH[parts[2]]}"
            if parts[2] in _BN_TO_BRANCH:
                return f"bn{m.group(1)}{m.group(2)}_branch{_BN_TO_BRANCH[parts[2]]}"
        return None
    if parts[0] in ("fpn", "rpn_head", "classifier_head", "mask_head"):
        return parts[1]
    return None


def read_keras_h5(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a Keras-format h5 into {layer_name: {weight_suffix: array}}.
    Nested sub-models (``rpn_model``) are flattened to their inner layer
    names."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else str(n) for n in g.attrs["layer_names"]]
        for lname in layer_names:
            lg = g[lname]
            wnames = [n.decode() if isinstance(n, bytes) else str(n) for n in lg.attrs.get("weight_names", [])]
            for wn in wnames:
                arr = np.asarray(lg[wn])
                clean = wn[:-2] if wn.endswith(":0") else wn
                inner, suffix = clean.rsplit("/", 1)
                # nested sub-model weights may be scoped
                # '<group>/<inner_layer>/<weight>:0': strip the group
                if inner.startswith(lname + "/"):
                    inner = inner[len(lname) + 1:]
                out.setdefault(inner, {})[suffix] = arr
    return out


def keras_to_variables(layers: Dict[str, Dict[str, np.ndarray]]) -> Tuple[Dict, List[str]]:
    """Reference-layout weights -> partial flax variable tree (numpy).
    Returns ``(tree, unmapped_layer_names)``."""
    tree: Dict = {}
    unmapped: List[str] = []
    for layer, weights in layers.items():
        mpath = _module_path(layer)
        if mpath is None:
            unmapped.append(layer)
            continue
        for suffix, arr in weights.items():
            if suffix not in _WEIGHT_MAP:
                log.warning("unknown keras weight %s/%s", layer, suffix)
                continue
            coll, leaf = _WEIGHT_MAP[suffix]
            if layer == "mrcnn_mask_deconv" and suffix == "kernel":
                arr = np.swapaxes(arr, 2, 3)  # [kh,kw,out,in] -> [kh,kw,in,out]
            node = tree.setdefault(coll, {})
            for p in mpath:
                node = node.setdefault(p, {})
            node[leaf] = arr
    if unmapped:
        log.info("keras import: %d unmapped layers: %s", len(unmapped), sorted(unmapped)[:10])
    return tree, unmapped


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, leaf) of a nested dict in sorted key order (``jax.tree_util``'s
    order for dicts)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def variables_to_keras(variables: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """Flax variable tree (numpy) -> reference-layout {layer: {weight: array}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for keys, leaf in _leaves(variables):
        coll, mpath, leaf_name = keys[0], keys[1:-1], keys[-1]
        layer = _keras_layer(mpath)
        if layer is None:
            continue
        if mpath and mpath[-1] == "BatchNorm_0" and leaf_name == "bias":
            suffix = "beta"  # flax BN bias == keras beta (conv bias stays bias)
        else:
            suffix = _LEAF_MAP.get((coll, leaf_name), leaf_name)
        arr = np.asarray(leaf)
        if layer == "mrcnn_mask_deconv" and suffix == "kernel":
            arr = np.swapaxes(arr, 2, 3)
        out.setdefault(layer, {})[suffix] = arr
    return out


_KERAS_WEIGHT_ORDER = ["kernel", "bias", "gamma", "beta", "moving_mean", "moving_variance"]


def write_keras_h5(layers: Dict[str, Dict[str, np.ndarray]], path: str) -> None:
    """Write {layer: {weight: array}} in the Keras save_weights layout the
    reference reads (layer_names / weight_names attrs)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in layers], dtype="S64")
        f.attrs["backend"] = b"tensorflow"
        for lname, weights in layers.items():
            lg = f.create_group(lname)
            wnames = [f"{lname}/{s}:0" for s in _KERAS_WEIGHT_ORDER if s in weights]
            lg.attrs["weight_names"] = np.array([n.encode() for n in wnames], dtype="S96")
            for s, arr in weights.items():
                lg.create_dataset(f"{lname}/{s}:0", data=np.asarray(arr))


def restore_from_keras_h5(
    model: torch.nn.Module, path: str, exclude: Optional[Sequence[str]] = None
) -> Tuple[List[str], List[str]]:
    """Load a reference-format .h5 into ``model`` by name, in place: the
    flax-named tree, carried to port names by ``weights.flax_to_state_dict``
    and loaded by ``checkpoints.partial_restore`` (its ``exclude`` regexes
    on the flax paths). Returns (loaded names, skipped names). Raises when
    the file holds ``rpn_*``/``mrcnn_*`` layers and none of them loaded
    (a name mapping that failed), unless ``exclude`` names the core."""
    from ..weights import flax_to_state_dict
    from .checkpoints import partial_restore

    layers = read_keras_h5(path)
    tree, _unmapped = keras_to_variables(layers)
    loaded, skipped = partial_restore(model, flax_to_state_dict(tree), exclude=exclude)
    core_stored = [n for n in layers if "rpn_" in n or "mrcnn_" in n]
    core_loaded = [n for n in loaded if "rpn" in n or "head" in n]
    core_excluded = any("rpn" in pat or "head" in pat or "mrcnn" in pat for pat in (exclude or ()))
    if core_stored and not core_loaded and not core_excluded:
        raise ValueError(
            f"keras import loaded none of the {len(core_stored)} rpn_*/mrcnn_* "
            f"layers present in {path} — layer-name mapping failed "
            f"(first stored: {sorted(core_stored)[:5]})"
        )
    return loaded, skipped
