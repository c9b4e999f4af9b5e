"""Seeded random weights, made on the device in a few large calls and
handed alike to the program (``load_state_dict``) and to the reference.

Every weight is drawn from one normal sample of the model's whole size: a
convolution's or dense layer's with variance 1 / fan_in (LeCun, as flax
initialises them), biases at 0.01, and each frozen batch norm near the
identity (scale 1 + 0.1 n, shift and mean 0.05 n, variance exp(0.1 n)), so
that every term of the layers is exercised. Then the weights are settled
as ``chip_smoke.settle_random_weights`` settles them, the stem divided by
255 (the tiles are u8 pixels), and the background logit's bias set to
:data:`BACKGROUND_BIAS`, far below any other logit, so that every proposal
is a detection candidate and every tile gives the configuration's full
``detection_max_instances``: a worst case for the host unmold, and the same
work on every seed. At ``chip_smoke``'s -3 the background still won most
proposals on some seeds, which then unmolded a tenth of the masks and ran
three times as fast.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.mrcnn import param_spec

_SCALE = {"bias": 0.01, "shift": 0.05, "mean": 0.05}
BACKGROUND_BIAS = -30.0


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg``'s model (``param_spec``'s names), f32 on
    ``device``, from ``seed``."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape, kind, fan_in in spec:
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if kind == "weight":
            t.mul_(fan_in ** -0.5)
        elif kind == "scale":
            t.mul_(0.1).add_(1.0)
        elif kind == "var":
            t.mul_(0.1).exp_()
        else:
            t.mul_(_SCALE[kind])
        out[name] = t
    out["backbone.conv1.weight"].mul_(1.0 / 255.0)
    out["classifier_head.mrcnn_class_logits.bias"][0] = BACKGROUND_BIAS
    return out

