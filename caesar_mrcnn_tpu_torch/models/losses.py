"""The five training losses and the dice mask loss, as pure functions of
predictions, targets and masks (port of ``caesar_mrcnn_tpu/models/losses.py``).

All compute in float32 whatever the model's dtype. Padded and inactive
entries enter as zero weights of masked means, and a mean over an empty
mask is 0. Cross-entropies are clamped at 0 as in the JAX code.

With a process group (``group``, data parallelism) every masked mean is
the one over the global batch, as the JAX package's sharded step computes
it: its numerator and denominator are summed over the ranks
(:func:`global_sums`), each rank's sum carrying the gradient of its own
terms only, so that summing the ranks' gradients gives the gradient of the
global loss. Averaging each rank's own mean (DDP's way) differs from it as
soon as the ranks hold different numbers of positive anchors or ROIs.
Without a group nothing is reduced.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import Config


def global_sums(*xs: torch.Tensor, group=None):
    """The scalars ``xs`` summed over the ranks of ``group`` (one
    all-reduce), each with the gradient of this rank's own ``x``:
    ``total + (x - x.detach())``, whose value is the total exactly.
    Without a group, ``xs`` unchanged."""
    if group is None:
        return xs
    totals = torch.stack([x.detach() for x in xs])
    dist.all_reduce(totals, group=group)
    return tuple(t + (x - x.detach()) for t, x in zip(totals.unbind(), xs))


def smooth_l1(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Huber with delta 1."""
    diff = (y_true - y_pred).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _safe_mean(values: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    num, den = global_sums((values * mask).sum(), mask.sum(), group=group)
    return torch.where(den > 0, num / den.clamp_min(1.0), torch.zeros_like(num))


def _ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-torch.gather(logp, -1, target[..., None].long())[..., 0]).clamp_min(0.0)


def rpn_class_loss(rpn_match: torch.Tensor, rpn_class_logits: torch.Tensor, group=None) -> torch.Tensor:
    """Objectness CE over non-neutral anchors. rpn_match [B, A] in
    {-1, 0, 1}; logits [B, A, 2]."""
    ce = _ce(rpn_class_logits, (rpn_match == 1).long())
    return _safe_mean(ce, (rpn_match != 0).float(), group)


def rpn_bbox_loss(target_deltas: torch.Tensor, rpn_match: torch.Tensor,
                  rpn_bbox: torch.Tensor, group=None) -> torch.Tensor:
    """Smooth-L1 over the delta components of positive anchors; targets are
    anchor-aligned [B, A, 4]."""
    loss = smooth_l1(target_deltas.float(), rpn_bbox.float())
    pos = (rpn_match == 1).float()[..., None].expand_as(loss)
    return _safe_mean(loss, pos, group)


def mrcnn_class_loss(
    target_class_ids: torch.Tensor,
    pred_class_logits: torch.Tensor,
    active_class_ids: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Head CE, averaged over ROIs whose predicted class is active in their
    own image (``active_class_ids`` [B, C]); ``class_weights`` [C] scales
    each ROI's CE by its target class's weight, the normalizer unchanged."""
    t = target_class_ids.long()
    ce = _ce(pred_class_logits, t)
    if class_weights is not None:
        ce = ce * class_weights[t]
    pred_class = pred_class_logits.argmax(-1)
    pred_active = torch.gather(active_class_ids, 1, pred_class).float()
    num, den = global_sums((ce * pred_active).sum(), pred_active.sum(), group=group)
    return torch.where(den > 0, num / den.clamp_min(1.0), torch.zeros_like(num))


def mrcnn_bbox_loss(target_deltas: torch.Tensor, target_class_ids: torch.Tensor,
                    pred_deltas: torch.Tensor, group=None) -> torch.Tensor:
    """Smooth-L1 of the target class's deltas on positive ROIs."""
    t = target_class_ids.long()
    picked = torch.gather(pred_deltas, 2, t[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    loss = smooth_l1(target_deltas.float(), picked.float())
    return _safe_mean(loss, (t > 0).float()[..., None].expand_as(loss), group)


def mrcnn_mask_loss(
    target_masks: torch.Tensor,
    target_class_ids: torch.Tensor,
    pred_masks: torch.Tensor,
    mask_loss_function: str = "binary_crossentropy",
    group=None,
) -> torch.Tensor:
    """Per-class mask BCE (or dice) on positive ROIs. target_masks
    [B, R, mh, mw]; pred_masks [B, R, mh, mw, C] sigmoid."""
    t = target_class_ids.long()
    pos = (t > 0).float()
    idx = t[:, :, None, None, None].expand(-1, -1, *pred_masks.shape[2:4], 1)
    y_pred = torch.gather(pred_masks, 4, idx)[..., 0].float()
    y_true = target_masks.float()
    eps = 1e-7
    if mask_loss_function == "dice_coef_loss":
        m = pos[..., None, None]
        inter, denom, n_pos = global_sums(
            (y_true * y_pred * m).sum(), (y_true * m).sum() + (y_pred * m).sum(), pos.sum(), group=group)
        dice = (2.0 * inter + eps) / (denom + eps)
        return torch.where(n_pos > 0, 1.0 - dice, torch.zeros_like(dice))
    p = y_pred.clamp(eps, 1.0 - eps)
    bce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
    return _safe_mean(bce, pos[..., None, None].expand_as(bce), group)


def compute_losses(
    outputs,
    rpn_match: torch.Tensor,
    rpn_target_deltas: torch.Tensor,
    active_class_ids: torch.Tensor,
    config: Config,
    class_weights: Optional[torch.Tensor] = None,
    group=None,
) -> Dict[str, torch.Tensor]:
    """The five losses and their weighted total (``config.loss_weights``,
    ``config.use_losses``); over the global batch of ``group``'s ranks
    when one is given. The mask head runs on the positive-ROI prefix, so
    the mask targets are cut to its length."""
    r_masks = outputs.masks.shape[1]
    losses = {
        "rpn_class_loss": rpn_class_loss(rpn_match, outputs.rpn_class_logits, group),
        "rpn_bbox_loss": rpn_bbox_loss(rpn_target_deltas, rpn_match, outputs.rpn_bbox, group),
        "mrcnn_class_loss": mrcnn_class_loss(
            outputs.target_class_ids, outputs.class_logits, active_class_ids, class_weights, group
        ),
        "mrcnn_bbox_loss": mrcnn_bbox_loss(
            outputs.target_deltas, outputs.target_class_ids, outputs.bbox_deltas, group
        ),
        "mrcnn_mask_loss": mrcnn_mask_loss(
            outputs.target_masks[:, :r_masks],
            outputs.target_class_ids[:, :r_masks],
            outputs.masks,
            config.mask_loss_function,
            group,
        ),
    }
    total = torch.zeros((), dtype=torch.float32, device=rpn_match.device)
    for name, value in losses.items():
        if config.use_losses.get(name, True):
            total = total + config.loss_weights.get(name, 1.0) * value
    losses["total_loss"] = total
    return losses
