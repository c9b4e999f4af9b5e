"""Optimizer, stage freezing, device molding, train and eval steps, and the
training loop (port of ``caesar_mrcnn_tpu/train/trainer.py``, one device).

The optimizer follows the optax chain of the JAX trainer, step for step:

1. clip by global norm (``gradient_clip_norm``): ``g / norm * max`` when
   ``norm >= max``, ``g`` otherwise, written out because
   ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``;
2. ``g + 2 * weight_decay * p`` on kernels only (:func:`decay_mask`): L2
   added to the gradient, not decoupled decay;
3. Adam (``b1 0.9, b2 0.999, eps 1e-8``, bias-corrected moments) or SGD
   with momentum (``trace = g + momentum * trace``), scaled by
   ``-learning_rate``.

Stage freezing (``layers`` other than ``all``) turns ``requires_grad`` off
for the frozen parameters: optax's ``set_to_zero`` gives them no update, and
they stay out of the global norm, as here.

Gradient accumulation (``grad_accum_steps = k > 1``) is
``optax.MultiSteps(every_k_schedule=k)`` around that chain: each call of
the train step is one micro-step, whose gradient joins the running mean
``acc + (g - acc) / (n + 1)``; on every k-th micro-step the chain runs on
that mean and the mean restarts at 0. In between, the parameters and the
optimizer's state do not move, and Adam's step count counts updates.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.generator import batch_to_device
from ..models.losses import compute_losses
from ..models.mask_rcnn import MaskRCNN, check_train_config, forward_train
from ..utils.anchors import get_anchors
from ..weights import flax_path

log = logging.getLogger(__name__)

# --------------------------------------------------------------- freezing

# Training-stage selectors: a parameter trains when any of its stage's
# patterns matches its flax path (the JAX trainer's regexes).
_STAGE_PATTERNS = {
    "heads": [r"^fpn\b|/fpn|fpn_", r"rpn", r"classifier_head", r"mask_head"],
    "3+": [r"res3", r"res4", r"res5", r"^fpn\b|/fpn|fpn_", r"rpn", r"classifier_head", r"mask_head"],
    "4+": [r"res4", r"res5", r"^fpn\b|/fpn|fpn_", r"rpn", r"classifier_head", r"mask_head"],
    "5+": [r"res5", r"^fpn\b|/fpn|fpn_", r"rpn", r"classifier_head", r"mask_head"],
    "all": [r".*"],
}


def trainable_mask(model: torch.nn.Module, layers: str) -> Dict[str, bool]:
    """Parameter name -> trainable under the stage selector."""
    pats = [re.compile(p) for p in _STAGE_PATTERNS[layers]]
    return {
        name: any(p.search(flax_path(name)[1]) for p in pats)
        for name, _ in model.named_parameters()
    }


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> weight decay applies: conv and dense kernels only,
    never batch norm scale/bias or biases."""
    out = {}
    for name, _ in model.named_parameters():
        s = flax_path(name)[1]
        out[name] = s.endswith("kernel") and "bn" not in s.lower() and "BatchNorm" not in s
    return out


# -------------------------------------------------------------- optimizer


class Optimizer:
    """The optax chain of the JAX trainer over the trainable parameters,
    with multi-tensor (``torch._foreach_*``) updates."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, config: Config, named_params: List[Tuple[str, torch.nn.Parameter]],
                 decay: Dict[str, bool]):
        self.kind = config.optimizer.lower()
        if self.kind not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {config.optimizer}")
        self.lr = float(config.learning_rate)
        self.momentum = float(config.learning_momentum)
        self.clip = float(config.gradient_clip_norm)
        self.wd2 = 2.0 * float(config.weight_decay)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.decay_idx = [i for i, n in enumerate(self.names) if decay[n]]
        self.count = 0  # updates applied
        self.accum_steps = int(config.grad_accum_steps or 1)
        self.mini_step = 0  # micro-steps in the running mean
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.state = {"mu": zeros(), "nu": zeros()} if self.kind == "adam" else {"trace": zeros()}
        if self.accum_steps > 1:
            self.state["acc"] = zeros()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One micro-step from the parameters' ``.grad``, which keep the raw
        gradients: an update when no accumulation is set or this micro-step
        completes k of them; nothing is read back to the host."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.accum_steps > 1:
            acc = self.state["acc"]
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            self.mini_step = 0
        # optax's global_norm: sqrt of the sum of each leaf's sum of
        # squares. Not torch's norms: on the CPU they accumulate in plain f32
        # and were 5e-4 off on a 12.8M-element kernel; sum() is cascaded.
        norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
        keep = norm < self.clip
        one = torch.ones_like(norm)
        grads = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.clip))
        if self.decay_idx and self.wd2:
            torch._foreach_add_([grads[i] for i in self.decay_idx],
                                [self.params[i] for i in self.decay_idx], alpha=self.wd2)
        self.count += 1
        if self.kind == "adam":
            mu, nu = self.state["mu"], self.state["nu"]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.B2)
            c = np.float32(self.count)
            bc1 = float(np.float32(1.0) - np.float32(self.B1) ** c)
            bc2 = float(np.float32(1.0) - np.float32(self.B2) ** c)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, self.EPS)
            update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        else:
            update = self.state["trace"]
            torch._foreach_mul_(update, self.momentum)
            torch._foreach_add_(update, grads)
        torch._foreach_add_(self.params, update, alpha=-self.lr)

    def state_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "count": self.count,
            "mini_step": self.mini_step,
            "state": {k: dict(zip(self.names, v)) for k, v in self.state.items()},
        }

    def load_state_dict(self, sd: Dict) -> None:
        if sd["kind"] != self.kind:
            raise ValueError(f"optimizer state is {sd['kind']}, this optimizer is {self.kind}")
        if set(sd["state"]) != set(self.state):
            raise ValueError(f"optimizer state holds {sorted(sd['state'])}, this optimizer {sorted(self.state)}")
        self.count = int(sd["count"])
        self.mini_step = int(sd.get("mini_step", 0))
        with torch.no_grad():
            for k, tensors in self.state.items():
                for name, t in zip(self.names, tensors):
                    t.copy_(sd["state"][k][name])


def make_optimizer(config: Config, model: MaskRCNN, layers: str = "all") -> Optimizer:
    """The optimizer of ``config.optimizer`` over the parameters that
    ``layers`` trains; turns ``requires_grad`` off for the others."""
    if getattr(config, "opt_state_dtype", "float32") not in ("float32", "", None):
        raise NotImplementedError("opt_state_dtype other than float32 is not ported yet (ROADMAP A11)")
    train = trainable_mask(model, layers)
    named = []
    for name, p in model.named_parameters():
        p.requires_grad_(train[name])
        if train[name]:
            named.append((name, p))
    return Optimizer(config, named, decay_mask(model))


# ------------------------------------------------------------------- mold


def _unpackbits(packed: torch.Tensor, count: int) -> torch.Tensor:
    """``np.unpackbits`` (big-endian bits) along the last axis, first
    ``count`` bits."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :count]


def mold_batch(batch: Dict[str, torch.Tensor], cfg: Config, num_anchors: Optional[int] = None) -> Dict:
    """Device molding of both wires (``generator.TrainingPipeline``): cast
    the images to f32 and subtract the mean pixel (a mono image is
    broadcast to the configured channels); for the compact wire scatter the
    RPN index lists into dense ``rpn_match`` [B, A] / ``rpn_deltas``
    [B, A, 4] (pad index A drops) and unpack the bit-packed GT masks.
    Other keys pass through."""
    b = dict(batch)
    images = batch["images"]
    if images.shape[-1] == 1 and cfg.image_shape[2] != 1:
        images = images.expand(*images.shape[:-1], cfg.image_shape[2])
    mean = torch.tensor(cfg.mean_pixel, dtype=torch.float32, device=images.device)
    b["images"] = images.float() - mean
    if "rpn_pos_idx" in batch:
        a = num_anchors if num_anchors is not None else get_anchors(cfg).shape[0]
        pos, neg = batch["rpn_pos_idx"].long(), batch["rpn_neg_idx"].long()
        n = pos.shape[0]
        match = torch.zeros((n, a + 1), dtype=torch.int32, device=pos.device)
        match.scatter_(1, neg, -1)
        match.scatter_(1, pos, 1)
        deltas = torch.zeros((n, a + 1, 4), dtype=torch.float32, device=pos.device)
        deltas.scatter_(1, pos[..., None].expand(-1, -1, 4), batch["rpn_pos_deltas"].float())
        b["rpn_match"], b["rpn_deltas"] = match[:, :a], deltas[:, :a]
        del b["rpn_pos_idx"], b["rpn_neg_idx"], b["rpn_pos_deltas"]
    else:
        b["rpn_match"] = batch["rpn_match"].to(torch.int32)
    if "gt_masks_packed" in batch:
        mh, mw = tuple(cfg.mini_mask_shape) if cfg.use_mini_mask else tuple(cfg.image_shape[:2])
        g = cfg.max_gt_instances
        bits = _unpackbits(batch["gt_masks_packed"], mh * mw * g)
        b["gt_masks"] = bits.reshape(bits.shape[:-1] + (mh, mw, g)).float()
        del b["gt_masks_packed"]
    else:
        b["gt_masks"] = batch["gt_masks"].float()
    return b


# ------------------------------------------------------------------ steps


def _forward_losses(model, b, anchors, rpn_std, cw, priorities, generator):
    cfg = model.config
    outputs = forward_train(
        model, b["images"], b["gt_class_ids"], b["gt_boxes"], b["gt_masks"], anchors, rpn_std,
        ext_rois=b.get("rois"), priorities=priorities, generator=generator,
    )
    active = b["image_meta"][:, 12:]
    return compute_losses(outputs, b["rpn_match"], b["rpn_deltas"], active, cfg, class_weights=cw)


def _step_constants(model, anchors, class_weights):
    dev = next(model.parameters()).device
    cfg = model.config
    anchors = torch.as_tensor(np.asarray(anchors), dtype=torch.float32).to(dev)
    rpn_std = torch.tensor(cfg.rpn_bbox_std_dev, dtype=torch.float32, device=dev)
    cw = None if class_weights is None else torch.as_tensor(class_weights, dtype=torch.float32).to(dev)
    return anchors, rpn_std, cw


def make_train_step(
    model: MaskRCNN,
    optimizer: Optimizer,
    anchors: np.ndarray,
    class_weights: Optional[np.ndarray] = None,
) -> Callable:
    """The train step: ``step(batch, priorities=None, generator=None)`` on a
    batch of device tensors (either wire) molds it, runs
    :func:`forward_train` and the losses, back-propagates and updates the
    parameters in place. Returns the detached losses, on the device.

    ``class_weights`` [C] weighs the head classification loss; a ``"rois"``
    key in the batch replaces the RPN proposals (``ext_rois``).
    """
    check_train_config(model.config)
    anchors, rpn_std, cw = _step_constants(model, anchors, class_weights)

    def step(batch: Dict[str, torch.Tensor], priorities=None, generator=None):
        b = mold_batch(batch, model.config, anchors.shape[0])
        optimizer.zero_grad()
        losses = _forward_losses(model, b, anchors, rpn_std, cw, priorities, generator)
        losses["total_loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(model: MaskRCNN, anchors: np.ndarray,
                   class_weights: Optional[np.ndarray] = None) -> Callable:
    """Forward-only losses of a validation batch."""
    check_train_config(model.config)
    anchors, rpn_std, cw = _step_constants(model, anchors, class_weights)

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor], priorities=None, generator=None):
        b = mold_batch(batch, model.config, anchors.shape[0])
        return _forward_losses(model, b, anchors, rpn_std, cw, priorities, generator)

    return step


# ------------------------------------------------------------------- loop


def train_loop(
    train_step: Callable,
    batches: Iterator[Dict],
    steps: int,
    device,
    generator: Optional[torch.Generator] = None,
    log_every: int = 50,
    callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> Dict[str, float]:
    """Run ``steps`` train steps (micro-steps under gradient accumulation)
    on host batches or batches already on ``device`` (``prefetch``);
    returns the last logged losses. Losses are read back to the host only
    every ``log_every`` steps and at the end."""
    history: Dict[str, float] = {}
    t_mark, i_mark = time.time(), 0
    for i in range(steps):
        losses = train_step(batch_to_device(next(batches), device), generator=generator)
        if (i + 1) % log_every == 0 or i == steps - 1:
            history = {k: float(v) for k, v in losses.items()}
            now = time.time()
            rate = (now - t_mark) / max(i + 1 - i_mark, 1)
            t_mark, i_mark = now, i + 1
            log.info("step %d/%d loss=%.4f (%.2f s/step) %s", i + 1, steps,
                     history.get("total_loss", float("nan")), rate,
                     {k: round(v, 4) for k, v in history.items() if k != "total_loss"})
            if callback is not None:
                callback(i + 1, history)
    return history
