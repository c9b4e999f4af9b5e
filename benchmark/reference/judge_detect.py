"""The comparison that decides ``correct`` for a detect cell: batches of
tiles that the timed window itself produced, judged by the float32
reference (:mod:`.mrcnn`) on the same tiles and weights.

The program's discrete choices (which proposals NMS kept, which
detections it chose) cannot be recomputed in another precision without
ties falling otherwise, so each stage is judged on the program's own
choices, as a served token is judged against the reference's logits.

The numbers compared (each with its limit in ``benchmark/limits/``):

* ``mask_far_share``: the share of the detections' 28x28 mask cells (the
  u8 wire) that lie more than ``MASK_FAR`` from the reference's mask head
  on the detection's own box: backbone, FPN, ROIAlign at 14, mask head.
  It is the number that a lower precision (the int8 control) moves most;
* ``det_box_gap``: each detection's box against the reference's box head
  on the program's proposals: the L-inf distance to the nearest refinement
  of a proposal in the detection's class, over that refinement's longer
  side (at least ``MIN_SIDE``), since bf16 errs on a box's deltas and so in
  proportion to its size: ROIAlign at 7, the box head, the refinement;
* ``proposal_box_rel``: each kept proposal against the nearest of the
  reference's decoded anchor boxes, over that box's longer side: the RPN's
  box deltas and their decoding;
* ``proposal_score_short``: how far the reference's objectness of that
  nearest box's anchor lies below the reference's ``pre_nms_limit``-th
  best (at most 0 when every proposal comes from an anchor that the
  reference also ranks in): the RPN's objectness and the proposals' top-k;
* exact invariants, limit 0 or the rounding of f32 IoUs:
  ``proposals_missing`` (fewer kept proposals than the budget),
  ``proposal_overlap`` and ``det_overlap`` (IoU above the NMS threshold
  between two kept boxes of one class), ``unmold_mismatch`` (the unmold's
  boxes, classes and scores against the fetched detections', mask pixels
  outside a detection's box) and ``tiles_missing``.

Diagnostics, printed but not compared, since neither the control nor a
planted fault reads them far enough above sound runs to hold a limit
(``PERF.md`` gives the readings): ``rpn_prob_gap`` and ``rpn_prob_rms``
(every anchor's foreground probability), ``det_score_gap`` (at the
proposal of ``det_box_gap``, the larger of the score gap and the gap by
which the detection's class lies below the reference's best class),
``det_missed_gap`` (the best reference score that no detection explains,
above the weakest detection's), ``mask_prob_gap`` (the widest mask cell
gap) and ``mask_pixel_gap`` (the widest margin by which the reference's
mask, resized into the unmold's pixel box, lies on the other side of 0.5
from the unmolded pixel).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import mrcnn as R

SAME_BOX = 0.02  # L-inf distance (normalized) within which two boxes are one
IOU_SLACK = 0.05  # a candidate within this of the NMS threshold counts as suppressed
CLASS_SLACK = 0.05  # a class this close to the best counts as a tie
MASK_FAR = 0.0075  # a mask cell this far from the reference's counts in mask_far_share
MIN_SIDE = 0.01  # the least box side (normalized) that det_box_gap divides by
CHUNK = 256

COMPARED = ("mask_far_share", "det_box_gap", "proposal_box_rel", "proposal_score_short", "proposals_missing",
            "proposal_overlap", "det_overlap", "unmold_mismatch", "tiles_missing")
DIAGNOSTICS = ("rpn_prob_gap", "rpn_prob_rms", "det_score_gap", "det_missed_gap", "mask_prob_gap", "mask_pixel_gap")
_COUNTS = ("proposals_missing", "unmold_mismatch", "tiles_missing")
_WIDEST = ("det_box_gap", "proposal_box_rel", "proposal_score_short", "proposal_overlap", "det_overlap", "rpn_prob_gap",
           "rpn_prob_rms", "det_score_gap", "det_missed_gap", "mask_prob_gap", "mask_pixel_gap")


def _linf_min(a: torch.Tensor, b: torch.Tensor):
    """For each row of a [N, 4]: (min L-inf distance to b [M, 4], argmin)."""
    dist, idx = [], []
    for s in range(0, a.shape[0], CHUNK):
        m = (a[s:s + CHUNK, None, :] - b[None, :, :]).abs().amax(-1).min(1)
        dist.append(m.values)
        idx.append(m.indices)
    if not dist:
        return a.new_zeros(0), torch.zeros(0, dtype=torch.long, device=a.device)
    return torch.cat(dist), torch.cat(idx)


def _overlap_excess(boxes: torch.Tensor, classes: torch.Tensor, thr: float) -> float:
    """The largest IoU above ``thr`` between two boxes of one class."""
    if boxes.shape[0] < 2:
        return 0.0
    ov = R.iou(boxes, boxes)
    same = (classes[:, None] == classes[None, :]) & torch.ones_like(ov, dtype=torch.bool).triu(1)
    return max(0.0, float(torch.where(same, ov, torch.zeros_like(ov)).max()) - thr)


def judge_batch(sd: Dict[str, torch.Tensor], cfg: Dict, tiles: np.ndarray, prog: Dict) -> Tuple[Dict, Dict]:
    """One batch: (its readings, its per-element gaps). ``tiles`` [B, H, W]
    u8 (what ``dispatch_tiles`` was given; the program's outputs may hold
    more rows, the padding of a short batch, which are not judged); ``prog``: the program's
    ``rpn_probs`` [B, A, 2] and ``proposals`` [B, P, 4] of the batch's step,
    its fetched ``detections`` [B, D, 6] and ``masks`` [B, D, mh, mw], and
    its unmolded ``results`` (one dict per tile)."""
    dev = sd["backbone.conv1.weight"].device
    b, h, w = tiles.shape
    out = {k: 0.0 for k in _COUNTS + _WIDEST}
    elements: Dict[str, List[torch.Tensor]] = {"rpn": [], "prop": [], "det": [], "mask": []}
    out["tiles_missing"] = float(max(0, b - len(prog["results"])))
    with torch.no_grad(), R.exact_f32():
        x = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev).float()
        x = x[..., None].expand(-1, -1, -1, cfg["image_channel_count"])
        pyramid = R.features(sd, cfg, x - torch.tensor(cfg["mean_pixel"], dtype=torch.float32, device=dev))
        _, probs, deltas = R.rpn(sd, pyramid)
        diff = prog["rpn_probs"][:b].to(dev).float()[..., 1] - probs[..., 1]
        out["rpn_prob_gap"] = float(diff.abs().max())
        out["rpn_prob_rms"] = float(diff.square().mean().sqrt())
        elements["rpn"].append(diff.abs().flatten().cpu())

        anchors = torch.from_numpy(R.anchors(cfg, (h, w))).to(dev)
        rpn_std = torch.tensor(cfg["rpn_bbox_std_dev"], dtype=torch.float32, device=dev)
        decoded = R.apply_box_deltas(anchors[None], deltas * rpn_std).clamp(0.0, 1.0)
        props = prog["proposals"][:b].to(dev).float()
        cut = torch.topk(probs[..., 1], min(cfg["pre_nms_limit"], probs.shape[1]), dim=1).values[:, -1]
        thr = cfg["rpn_nms_threshold"]
        budget = props.shape[1]
        for i in range(b):
            p = props[i][(props[i] != 0).any(-1)]
            out["proposals_missing"] += float(budget - p.shape[0])
            if p.shape[0]:
                dist, near = _linf_min(p, decoded[i])
                nb = decoded[i][near]
                side = (nb[:, 2:] - nb[:, :2]).amax(-1).clamp_min(MIN_SIDE)
                out["proposal_box_rel"] = max(out["proposal_box_rel"], float((dist / side).max()))
                short = cut[i] - probs[i, near, 1]
                out["proposal_score_short"] = max(out["proposal_score_short"], float(short.max()))
                elements["prop"].append(short.cpu())
            out["proposal_overlap"] = max(out["proposal_overlap"],
                                          _overlap_excess(p, torch.zeros(p.shape[0], device=dev), thr))

        cls_probs, cls_deltas = R.classifier(sd, R.roi_align(pyramid[:4], props, (h, w), cfg["pool_size"]))
        bbox_std = torch.tensor(cfg["bbox_std_dev"], dtype=torch.float32, device=dev)
        # every proposal refined in every class: [B, P, K, 4], clipped to the tile
        refined = R.apply_box_deltas(props[:, :, None, :], cls_deltas * bbox_std).clamp(0.0, 1.0)
        dets = torch.from_numpy(np.asarray(prog["detections"][:b], dtype=np.float32)).to(dev)
        dthr = cfg["detection_nms_threshold"]
        for i in range(b):
            d = dets[i][dets[i, :, 4] > 0]
            valid = (props[i, :, 2] - props[i, :, 0]) * (props[i, :, 3] - props[i, :, 1]) > 0
            pi, ri = cls_probs[i][valid], refined[i][valid]
            best, kbest = pi.max(1)
            explained = torch.zeros(pi.shape[0], dtype=torch.bool, device=dev)
            if d.shape[0]:
                c = d[:, 4].long()
                p_c = pi[:, c].T  # [D, P']
                box_c = ri[:, c].permute(1, 0, 2)  # [D, P', 4]
                box_err = (d[:, None, :4] - box_c).abs().amax(-1)
                j = box_err.argmin(1)  # the proposal whose refinement gives the detection's box
                rows = torch.arange(d.shape[0], device=dev)
                side = (box_c[rows, j, 2:] - box_c[rows, j, :2]).amax(-1).clamp_min(MIN_SIDE)
                out["det_box_gap"] = max(out["det_box_gap"], float((box_err[rows, j] / side).max()))
                score_gap = torch.maximum((d[:, 5] - p_c[rows, j]).abs(), best[j] - p_c[rows, j])
                out["det_score_gap"] = max(out["det_score_gap"], float(score_gap.max()))
                elements["det"].append(box_err[rows, j].cpu())
                out["det_overlap"] = max(out["det_overlap"], _overlap_excess(d[:, :4], c, dthr))
                rb = ri[torch.arange(ri.shape[0], device=dev), kbest]
                near = R.iou(rb, d[:, :4]) >= dthr - IOU_SLACK  # [P', D]
                tie = pi[:, c] >= best[:, None] - CLASS_SLACK
                explained |= (near & tie).any(1) | (_linf_min(rb, d[:, :4])[0] <= SAME_BOX)
                explained[j] = True
            weakest = float(d[:, 5].min()) if d.shape[0] >= cfg["detection_max_instances"] else 0.0
            missed = best[(kbest > 0) & ~explained]
            if missed.numel():
                out["det_missed_gap"] = max(out["det_missed_gap"], float(missed.max()) - weakest)
        del cls_probs, cls_deltas, refined

        masks_ref = R.mask_head(sd, R.roi_align(pyramid[:4], dets[..., :4].contiguous(), (h, w),
                                                cfg["mask_pool_size"]))
        idx = dets[..., 4].long()[:, :, None, None, None].expand(-1, -1, 1, *masks_ref.shape[3:])
        masks_ref = torch.gather(masks_ref, 2, idx)[:, :, 0]  # [B, D, mh, mw]
        masks_prog = torch.from_numpy(np.asarray(prog["masks"][:b])).to(dev).float()
        if np.asarray(prog["masks"]).dtype == np.uint8:
            masks_prog = masks_prog / 255.0
        mdiff = (masks_prog - masks_ref).abs()[dets[..., 4] > 0]
        if mdiff.numel():
            out["mask_prob_gap"] = float(mdiff.max())
        elements["mask"].append(mdiff.flatten().cpu())
        for i, res in enumerate(prog["results"][:b]):
            out["unmold_mismatch"] += _judge_unmold(dets[i].cpu().numpy(), masks_ref[i], res, (h, w), out)
    return out, {k: torch.cat(v) if v else torch.zeros(0) for k, v in elements.items()}


def _judge_unmold(det: np.ndarray, masks_ref: torch.Tensor, res: Dict, shape, out: Dict) -> float:
    """Mismatches of one tile's unmolded result against its detections;
    widens ``out["mask_pixel_gap"]``."""
    zero = np.where(det[:, 4] == 0)[0]
    n = int(zero[0]) if zero.size else det.shape[0]
    scale = np.array([shape[0] - 1, shape[1] - 1, shape[0] - 1, shape[1] - 1])
    boxes = np.around(det[:n, :4] * scale + np.array([0, 0, 1, 1])).astype(np.int32)
    keep = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0
    rows = np.flatnonzero(keep)
    want = (boxes[keep], det[:n, 4][keep].astype(np.int32), det[:n, 5][keep])
    got = (np.asarray(res["rois"]), np.asarray(res["class_ids"]), np.asarray(res["scores"]))
    if any(g.shape[0] != len(rows) for g in got) or res["masks"].shape != tuple(shape) + (len(rows),):
        return 1.0
    bad = float((want[0] != got[0]).any(1).sum() + (want[1] != got[1]).sum() + (want[2] != got[2]).sum())
    for k, r in enumerate(rows):
        y1, x1, y2, x2 = (int(v) for v in boxes[r])
        frame = np.asarray(res["masks"][..., k])
        inside = frame[y1:y2, x1:x2]
        if int(frame.sum()) != int(inside.sum()):
            bad += 1.0
        p = F.interpolate(masks_ref[r][None, None], size=(y2 - y1, x2 - x1), mode="bilinear",
                          align_corners=False)[0, 0]
        wrong = torch.from_numpy(np.ascontiguousarray(inside)).to(p.device) != (p >= 0.5)
        if bool(wrong.any()):
            out["mask_pixel_gap"] = max(out["mask_pixel_gap"], float((p[wrong] - 0.5).abs().max()))
    return bad


def merge(readings: List[Tuple[Dict, Dict]]) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the numbers compared, the diagnostics) over the judged batches:
    counts add, gaps take the widest, shares pool the elements."""
    pooled = {k: sum(r[0][k] for r in readings) for k in _COUNTS}
    widest = {k: max(r[0][k] for r in readings) for k in _WIDEST}
    cells = torch.cat([r[1]["mask"] for r in readings])
    values = {**pooled, **widest,
              "mask_far_share": float((cells > MASK_FAR).float().mean()) if cells.numel() else 0.0}
    return {k: values[k] for k in COMPARED}, {k: values[k] for k in DIAGNOSTICS}


def distribution(readings: List[Tuple[Dict, Dict]]) -> Dict[str, Dict[str, float]]:
    """Quantiles and shares beyond a few tolerances of each per-element
    gap over the judged batches (for setting tolerances and limits)."""
    out = {}
    for k in ("rpn", "prop", "det", "mask"):
        v = torch.cat([r[1][k].float() for r in readings]) if readings else torch.zeros(0)
        if v.numel() == 0:
            out[k] = {"n": 0}
            continue
        q = torch.quantile(v[torch.randperm(v.numel())[:1 << 20]], torch.tensor([0.5, 0.9, 0.99, 0.999]))
        out[k] = {"n": int(v.numel()), "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
                  "p999": float(q[3]), "max": float(v.max())}
        for t in (0.001, 0.002, 0.005, 0.0075, 0.01, 0.02, 0.05, 0.1, 0.2):
            out[k][f">{t}"] = float((v > t).float().mean())
    return out
