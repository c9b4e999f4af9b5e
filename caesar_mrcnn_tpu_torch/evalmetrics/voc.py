"""Pascal-VOC detection AP (every-point and 11-point interpolation).

Fresh implementation of the metric the reference obtains from the vendored
Padilla Object-Detection-Metrics tool (reference:
Object-Detection-Metrics/lib/Evaluator.py:24-52 GetPascalVOCMetrics,
~:292 CalculateAveragePrecision, ElevenPointInterpolatedAP). Consumes the
same data model: per-image ground-truth boxes and scored detections, boxes
as (x1, y1, x2, y2).

The port's copy of ``caesar_mrcnn_tpu/evalmetrics/voc.py``, unchanged in behaviour
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class BBox:
    image_id: str
    class_name: str
    box: Tuple[float, float, float, float]  # x1, y1, x2, y2
    score: Optional[float] = None  # None for ground truth


def box_iou(b1, b2) -> float:
    """Pixel-inclusive IoU, matching the Padilla tool's convention of
    +1-pixel widths/heights (reference:
    Object-Detection-Metrics/lib/Evaluator.py:382-426) — boxes are integer
    pixel corners and a box whose corners coincide still covers one pixel."""
    x1 = max(b1[0], b2[0])
    y1 = max(b1[1], b2[1])
    x2 = min(b1[2], b2[2])
    y2 = min(b1[3], b2[3])
    if x2 < x1 or y2 < y1:
        return 0.0
    inter = (x2 - x1 + 1) * (y2 - y1 + 1)
    a1 = (b1[2] - b1[0] + 1) * (b1[3] - b1[1] + 1)
    a2 = (b2[2] - b2[0] + 1) * (b2[3] - b2[1] + 1)
    return inter / (a1 + a2 - inter)


def every_point_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """All-point interpolated AP (Padilla CalculateAveragePrecision)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def eleven_point_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """11-point interpolated AP (Padilla ElevenPointInterpolatedAP)."""
    ap = 0.0
    for r in np.linspace(0, 1, 11):
        mask = recalls >= r
        p = float(precisions[mask].max()) if mask.any() else 0.0
        ap += p / 11.0
    return ap


def evaluate_class(
    gts: List[BBox],
    dets: List[BBox],
    iou_threshold: float = 0.5,
    method: str = "every_point",
) -> Dict:
    """AP for one class via greedy per-image matching (each GT consumed
    once, detections processed in descending score)."""
    npos = len(gts)
    dets = sorted(dets, key=lambda d: -(d.score or 0.0))
    gt_by_img: Dict[str, List[BBox]] = {}
    for g in gts:
        gt_by_img.setdefault(g.image_id, []).append(g)
    used: Dict[str, np.ndarray] = {
        img: np.zeros(len(lst), dtype=bool) for img, lst in gt_by_img.items()
    }

    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, d in enumerate(dets):
        candidates = gt_by_img.get(d.image_id, [])
        iou_best, j_best = 0.0, -1
        for j, g in enumerate(candidates):
            iou = box_iou(d.box, g.box)
            if iou > iou_best:
                iou_best, j_best = iou, j
        if j_best >= 0 and iou_best >= iou_threshold and not used[d.image_id][j_best]:
            tp[i] = 1
            used[d.image_id][j_best] = True
        else:
            fp[i] = 1

    acc_tp = np.cumsum(tp)
    acc_fp = np.cumsum(fp)
    recalls = acc_tp / max(npos, 1)
    precisions = np.divide(acc_tp, np.maximum(acc_tp + acc_fp, 1e-12))
    ap = (
        every_point_ap(recalls, precisions)
        if method == "every_point"
        else eleven_point_ap(recalls, precisions)
    )
    return {
        "AP": ap,
        "precision": precisions,
        "recall": recalls,
        "total_positives": npos,
        "total_TP": float(acc_tp[-1]) if len(dets) else 0.0,
        "total_FP": float(acc_fp[-1]) if len(dets) else 0.0,
    }


def pascal_voc_metrics(
    gts: Sequence[BBox],
    dets: Sequence[BBox],
    iou_threshold: float = 0.5,
    method: str = "every_point",
) -> Dict[str, Dict]:
    """Per-class AP table + mAP (Padilla GetPascalVOCMetrics equivalent)."""
    classes = sorted({g.class_name for g in gts} | {d.class_name for d in dets})
    out: Dict[str, Dict] = {}
    aps = []
    for cls in classes:
        res = evaluate_class(
            [g for g in gts if g.class_name == cls],
            [d for d in dets if d.class_name == cls],
            iou_threshold,
            method,
        )
        res["class"] = cls
        out[cls] = res
        aps.append(res["AP"])
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    return out


# ------------------------------------------------- Padilla txt-dir format


def write_padilla_dirs(
    gts: Sequence[BBox], dets: Sequence[BBox], gt_dir: str, det_dir: str
) -> None:
    """Dump per-image txt files in the Padilla CLI format — the reference
    produces these for the external tool (reference:
    mrcnn/analyze.py:458-530): GT rows ``class x1 y1 x2 y2``, detection rows
    ``class score x1 y1 x2 y2`` (xyrb coordinates)."""
    import os

    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(det_dir, exist_ok=True)
    by_img_gt: Dict[str, List[BBox]] = {}
    by_img_det: Dict[str, List[BBox]] = {}
    for g in gts:
        by_img_gt.setdefault(g.image_id, []).append(g)
    for d in dets:
        by_img_det.setdefault(d.image_id, []).append(d)
    for img in set(by_img_gt) | set(by_img_det):
        with open(os.path.join(gt_dir, f"{img}.txt"), "w") as f:
            for g in by_img_gt.get(img, []):
                x1, y1, x2, y2 = g.box
                f.write(f"{g.class_name} {x1:.0f} {y1:.0f} {x2:.0f} {y2:.0f}\n")
        with open(os.path.join(det_dir, f"{img}.txt"), "w") as f:
            for d in by_img_det.get(img, []):
                x1, y1, x2, y2 = d.box
                f.write(f"{d.class_name} {d.score:.6f} {x1:.0f} {y1:.0f} {x2:.0f} {y2:.0f}\n")


def read_padilla_dirs(gt_dir: str, det_dir: str) -> Tuple[List[BBox], List[BBox]]:
    """Read the txt-dir format back (parity oracle for the vendored tool)."""
    import os

    gts: List[BBox] = []
    dets: List[BBox] = []
    for name in sorted(os.listdir(gt_dir)):
        img = os.path.splitext(name)[0]
        with open(os.path.join(gt_dir, name)) as f:
            for line in f:
                p = line.split()
                if len(p) >= 5:
                    gts.append(BBox(img, p[0], tuple(float(v) for v in p[1:5])))
    for name in sorted(os.listdir(det_dir)):
        img = os.path.splitext(name)[0]
        with open(os.path.join(det_dir, name)) as f:
            for line in f:
                p = line.split()
                if len(p) >= 6:
                    dets.append(
                        BBox(img, p[0], tuple(float(v) for v in p[2:6]), float(p[1]))
                    )
    return gts, dets
