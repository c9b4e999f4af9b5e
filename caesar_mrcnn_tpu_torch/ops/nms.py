"""Batched static-shape greedy NMS: the CUDA kernel and its plain version.

Port of ``caesar_mrcnn_tpu/ops/nms.py::nms_padded`` (contract at its
``:277-303``), batched over images where the JAX code used ``vmap``:

* boxes are sorted by score, descending and stable;
* boxes with a ``-inf`` score are invalid and zeroed;
* a box is suppressed when its IoU with a kept, higher-ranked box is
  strictly greater than the threshold; IoU with a zero-area box is 0;
* the result is ``(idx [B, max_output] int32`` into the input order,
  ``valid [B, max_output] bool)``; padding slots hold index 0, not valid.

:func:`nms_padded` runs ``csrc/nms.cu`` for CUDA tensors and
:func:`nms_sorted_plain` for CPU tensors; the plain version is the tests'
oracle, and nothing falls back to it on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels


def pairwise_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """IoU [..., n1, n2] in the order of ``_pairwise_iou`` (JAX
    ``ops/nms.py:32-42``); zero-area boxes give 0."""
    y1 = torch.maximum(b1[..., :, None, 0], b2[..., None, :, 0])
    x1 = torch.maximum(b1[..., :, None, 1], b2[..., None, :, 1])
    y2 = torch.minimum(b1[..., :, None, 2], b2[..., None, :, 2])
    x2 = torch.minimum(b1[..., :, None, 3], b2[..., None, :, 3])
    inter = (y2 - y1).clamp_min(0.0) * (x2 - x1).clamp_min(0.0)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0.0, inter / union, torch.zeros_like(union))


def sort_boxes(boxes: torch.Tensor, scores: torch.Tensor):
    """Stable descending sort by score: (sorted boxes with invalid ones
    zeroed, sorted validity, order) -- the inputs of the sweep."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    svalid = torch.gather(scores, 1, order) > -float("inf")
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sboxes = torch.where(svalid[..., None], sboxes, torch.zeros_like(sboxes))
    return sboxes.contiguous(), svalid.contiguous(), order


def nms_sorted_plain(
    sboxes: torch.Tensor,
    svalid: torch.Tensor,
    order: torch.Tensor,
    max_output: int,
    iou_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch greedy sweep over score-sorted boxes (any device).

    The loop runs over sorted positions for all images at once and never
    reads a value back to the host.
    """
    b, n = svalid.shape
    sup = pairwise_iou(sboxes, sboxes) > iou_threshold
    sup &= torch.ones(n, n, dtype=torch.bool, device=sboxes.device).triu(1)
    removed = ~svalid
    keep = torch.zeros_like(svalid)
    for i in range(n):
        k = ~removed[:, i]
        keep[:, i] = k
        removed |= sup[:, i] & k[:, None]
    rank = keep.cumsum(1)
    keep &= rank <= max_output
    slot = torch.where(keep, rank - 1, torch.full_like(rank, max_output))
    idx = torch.zeros(b, max_output + 1, dtype=order.dtype, device=order.device)
    idx.scatter_(1, slot, torch.where(keep, order, torch.zeros_like(order)))
    count = keep.sum(1, keepdim=True)
    valid = torch.arange(max_output, device=order.device)[None, :] < count
    return idx[:, :max_output].to(torch.int32), valid


def _nms_cuda(boxes, scores, order, max_output: int, iou_threshold: float):
    """The kernels of ``csrc/nms.cu`` on the unsorted boxes and scores and
    the sort order: the mask kernel gathers and zeroes the sorted boxes
    itself."""
    b, n = scores.shape
    words = (n + 63) // 64
    if words * 8 > 48 * 1024:
        raise ValueError(f"nms kernel takes at most {48 * 1024 * 8} boxes, got {n}")
    dev = boxes.device
    scratch = torch.empty(b * n * words + b * words, dtype=torch.int64, device=dev)  # mask, validity
    state = torch.empty(b * (2 + max_output), dtype=torch.int32, device=dev)  # between the phases
    idx = torch.empty((b, max_output), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_output), dtype=torch.bool, device=dev)
    status = _kernels.library().caesar_nms(
        boxes.data_ptr(), scores.data_ptr(), order.data_ptr(), b, n, float(iou_threshold),
        max_output, scratch.data_ptr(), state.data_ptr(), idx.data_ptr(), valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(status, "caesar_nms")
    nms_padded.launches += 1
    return idx, valid


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output: int,
    iou_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with static shapes, batched.

    Args:
      boxes: [B, N, 4] float32 (y1, x1, y2, x2).
      scores: [B, N] float32; ``-inf`` marks an invalid box.
      max_output: kept indices to return per image.
      iou_threshold: suppress when IoU > threshold.

    Returns (idx [B, max_output] int32 into the input order, valid
    [B, max_output] bool). CUDA tensors run the kernel (and count one
    launch in ``nms_padded.launches``); CPU tensors run the plain version.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes {tuple(boxes.shape)} / scores {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_padded takes float32 boxes and scores")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores on different devices")
    if boxes.shape[1] == 0 or max_output < 1:
        raise ValueError("nms_padded needs at least one box and max_output >= 1")
    if boxes.device.type == "cpu":
        return nms_sorted_plain(*sort_boxes(boxes, scores), max_output, iou_threshold)
    if boxes.device.type != "cuda":
        raise RuntimeError(f"nms_padded: no kernel for device {boxes.device}")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return _nms_cuda(boxes, scores, order, max_output, iou_threshold)


nms_padded.launches = 0
