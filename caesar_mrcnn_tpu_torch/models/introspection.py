"""Model introspection: intermediate-activation capture and parameter
inventory, on a ``MaskRCNN`` ``nn.Module``.

The port of ``caesar_mrcnn_tpu/models/introspection.py`` (the reference's
``run_graph`` mrcnn/model.py:2786-2851 and ``get_trainable_layers``
mrcnn/model.py:2858-2872). Where flax's ``capture_intermediates`` hands
back every submodule's outputs by path, :func:`run_graph` registers a
forward hook on every submodule for the one call and removes them after.

Names are the port's own: a module's dotted name (``fpn.fpn_p2``) where
flax has its path (``fpn/fpn_p2``), and parameter names as in the
``state_dict`` (``weights.flax_path`` maps one to the other).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import torch


def _flatten(value, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out[prefix] = value


def run_graph(model, images, method=None, filter_regex: Optional[str] = None) -> Dict[str, Any]:
    """Run a forward method of ``model`` on ``images`` (NHWC; a tensor or a
    numpy array, moved to the model's device) without gradient, capturing
    every submodule's output.

    Returns ``{"outputs": ..., "intermediates": {name: tensor}}``: one entry
    per submodule call, named ``<module name>[<call>]`` (a module called
    twice gives ``[0]`` and ``[1]``), with ``[i]`` appended for each level
    of a tuple output, as the JAX package's paths end in ``__call__[i]``;
    only the names that ``filter_regex`` matches, if one is given.
    """
    from .mask_rcnn import MaskRCNN

    method = method or MaskRCNN.features
    device = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    flat: Dict[str, Any] = {}
    calls: Dict[str, int] = {}

    def hook(name):
        def capture(module, args, output):
            i = calls.get(name, 0)
            calls[name] = i + 1
            _flatten(output, f"{name}[{i}]", flat)
        return capture

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules() if name]
    try:
        with torch.no_grad():
            out = method(model, images)
    finally:
        for h in handles:
            h.remove()
    if filter_regex:
        pat = re.compile(filter_regex)
        flat = {k: v for k, v in flat.items() if pat.search(k)}
    return {"outputs": out, "intermediates": flat}


def get_trainable_layers(model, layers: str = "all") -> List[str]:
    """Names of the parameters that train under a stage selector
    (``train.trainer.trainable_mask``; reference: mrcnn/model.py:2858-2872)."""
    from ..train.trainer import trainable_mask

    return sorted(name for name, trains in trainable_mask(model, layers).items() if trains)


def count_params(model) -> Dict[str, int]:
    """Total and per-top-level-module parameter counts (parameters only, as
    the JAX package counts its ``params`` collection; batch-norm statistics
    are buffers)."""
    counts: Dict[str, int] = {"total": 0}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        counts[top] = counts.get(top, 0) + p.numel()
        counts["total"] += p.numel()
    return counts
