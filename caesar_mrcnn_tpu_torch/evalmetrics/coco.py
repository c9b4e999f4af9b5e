"""COCO-style mAP over an IoU-threshold range from box-json dicts.

Fresh implementation of the role of the reference's vendored tarlen5 tool
(reference: tarlen5-calculate-mean-ap/calculate.py:40-274): per-image greedy
IoU-descending matching, model-score sweep for precision/recall curves, and
AP averaged over IoU thresholds. Boxes are ``[x1, y1, x2, y2]``.

The port's copy of ``caesar_mrcnn_tpu/evalmetrics/coco.py``, unchanged in behaviour
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .voc import box_iou


def get_single_image_results(
    gt_boxes: Sequence[Sequence[float]],
    pred_boxes: Sequence[Sequence[float]],
    iou_thr: float,
) -> Dict[str, int]:
    """TP/FP/FN for one image via greedy IoU-descending matching
    (reference: tarlen5 calculate.py:80-139)."""
    if len(gt_boxes) == 0:
        return {"true_pos": 0, "false_pos": len(pred_boxes), "false_neg": 0}
    if len(pred_boxes) == 0:
        return {"true_pos": 0, "false_pos": 0, "false_neg": len(gt_boxes)}

    pairs = []
    for ip, p in enumerate(pred_boxes):
        for ig, g in enumerate(gt_boxes):
            iou = box_iou(p, g)
            if iou > iou_thr:
                pairs.append((iou, ip, ig))
    pairs.sort(key=lambda t: -t[0])
    used_p, used_g = set(), set()
    tp = 0
    for iou, ip, ig in pairs:
        if ip in used_p or ig in used_g:
            continue
        used_p.add(ip)
        used_g.add(ig)
        tp += 1
    return {
        "true_pos": tp,
        "false_pos": len(pred_boxes) - tp,
        "false_neg": len(gt_boxes) - tp,
    }


def calc_precision_recall(image_results: Dict[str, Dict[str, int]]) -> Tuple[float, float]:
    """(reference: tarlen5 calculate.py:142-171)."""
    tp = sum(r["true_pos"] for r in image_results.values())
    fp = sum(r["false_pos"] for r in image_results.values())
    fn = sum(r["false_neg"] for r in image_results.values())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    return precision, recall


def get_avg_precision_at_iou(
    gt_boxes: Dict[str, List],
    pred_boxes: Dict[str, Dict],
    iou_thr: float = 0.5,
) -> Dict:
    """Score-sweep AP at one IoU threshold, numerically identical to the
    vendored tool (reference: tarlen5 calculate.py:192-274) including its
    quirks: the sweep visits every unique model score EXCEPT the highest,
    keeps predictions with score strictly greater than the threshold, and
    the all-detections PR point is therefore never sampled.

    gt_boxes: {image_id: [box, ...]} (``{"boxes": [...]}`` dicts accepted)
    pred_boxes: {image_id: {"boxes": [...], "scores": [...]}}
    """
    gt_norm = {
        k: (v["boxes"] if isinstance(v, dict) else v) for k, v in gt_boxes.items()
    }
    # score -> image ids containing that score (reference: calculate.py:173-190)
    model_scores_map: Dict[float, List[str]] = {}
    for img_id, pb in pred_boxes.items():
        for s in pb.get("scores", []):
            model_scores_map.setdefault(s, []).append(img_id)
    sorted_scores = sorted(model_scores_map)

    # Per-image predictions sorted ascending by score so pruning is a
    # prefix drop (reference: calculate.py:219-226).
    boxes_by_img: Dict[str, List] = {}
    scores_by_img: Dict[str, List[float]] = {}
    for img_id, pb in pred_boxes.items():
        order = np.argsort(pb.get("scores", []), kind="stable")
        boxes_by_img[img_id] = [pb["boxes"][i] for i in order]
        scores_by_img[img_id] = [pb["scores"][i] for i in order]

    precisions_l, recalls_l, thrs = [], [], []
    img_results: Dict[str, Dict[str, int]] = {}
    for ithr, thr in enumerate(sorted_scores[:-1]):
        # First pass seeds every GT image; later passes only re-evaluate
        # images whose prediction set changed (reference: calculate.py:235).
        img_ids = list(gt_norm.keys()) if ithr == 0 else model_scores_map[thr]
        for img_id in img_ids:
            scores = scores_by_img.get(img_id, [])
            start = 0
            while start < len(scores) and scores[start] <= thr:
                start += 1
            scores_by_img[img_id] = scores[start:]
            boxes_by_img[img_id] = boxes_by_img.get(img_id, [])[start:]
            img_results[img_id] = get_single_image_results(
                gt_norm.get(img_id, []), boxes_by_img[img_id], iou_thr
            )
        p, r = calc_precision_recall(img_results)
        precisions_l.append(p)
        recalls_l.append(r)
        thrs.append(thr)

    precisions = np.asarray(precisions_l)
    recalls = np.asarray(recalls_l)
    prec_at_rec = []
    for rlevel in np.linspace(0.0, 1.0, 11):
        mask = recalls >= rlevel
        prec_at_rec.append(float(precisions[mask].max()) if mask.any() else 0.0)
    return {
        "avg_prec": float(np.mean(prec_at_rec)),
        "precisions": precisions.tolist(),
        "recalls": recalls.tolist(),
        "model_thrs": thrs,
    }


def coco_map(
    gt_boxes: Dict[str, List],
    pred_boxes: Dict[str, Dict],
    iou_thrs: Optional[Sequence[float]] = None,
) -> Dict:
    """AP averaged over IoU thresholds 0.5..0.75 (tarlen5 main sweep)."""
    iou_thrs = list(iou_thrs) if iou_thrs is not None else list(np.arange(0.5, 0.76, 0.05))
    aps = {}
    for t in iou_thrs:
        aps[round(float(t), 2)] = get_avg_precision_at_iou(gt_boxes, pred_boxes, t)["avg_prec"]
    return {"mAP": float(np.mean(list(aps.values()))) if aps else 0.0, "per_iou": aps}


def write_box_jsons(
    gt_boxes: Dict[str, List], pred_boxes: Dict[str, Dict],
    gt_path: str, pred_path: str,
) -> None:
    """Dump the tarlen5-compatible json files
    (reference producer: mrcnn/analyze.py:458-530)."""
    with open(gt_path, "w") as f:
        json.dump(gt_boxes, f, indent=2)
    with open(pred_path, "w") as f:
        json.dump(pred_boxes, f, indent=2)
