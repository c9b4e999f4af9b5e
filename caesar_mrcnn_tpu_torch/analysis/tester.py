"""Dataset-level evaluation loop (the ``test`` run mode).

Re-design of the reference ``ModelTester`` (reference:
mrcnn/analyze.py:65-575): per-image detection + GT matching, aggregation of
the classification matrix / completeness / reliability, CSV tables rewritten
after every image, and mAP computation with dumps in the three external
evaluator formats (Padilla txt dirs, tarlen5 box jsons, metric-computation
json).

The port's copy of ``caesar_mrcnn_tpu/analysis/tester.py``, with the same
tables and dumps, on the port's ``Detector``. One behaviour differs, and
only under a failure: the JAX package logs an exception from
``detector.detect`` and moves on to the next batch, leaving its images
uncounted; here it propagates, so that a kernel that fails to build or
launch on the card stops the run instead of thinning the evaluation. An
error while loading a batch or evaluating one image's detections is logged
and skipped, as there.
"""

from __future__ import annotations

import collections
import csv
import json
import os
from typing import Dict, List, Optional

import numpy as np

from .. import logger
from ..config import Config
from ..evalmetrics import ap as AP
from ..evalmetrics import coco as COCO
from ..evalmetrics import voc as VOC
from ..utils.boxes import extract_bboxes
from .analyzer import Analyzer, NumpyEncoder
from .gt_eval import evaluate_image, extract_gt_masks


class ModelTester:
    def __init__(self, detector, config: Config, dataset):
        self.detector = detector
        self.config = config
        self.dataset = dataset
        self.analyzer = Analyzer(detector, config, dataset)
        self.n_classes = config.num_classes
        self.class_names = list(config.class_names)

        self.score_thr = config.score_thr
        self.iou_thr = config.iou_thr
        self.n_max_img = -1
        # Optional detected-id -> GT-id remap, used when the model was
        # trained with a different class dictionary
        # (reference flags: scripts/run.py:1289-1291).
        self.classid_remap_dict: Dict[int, int] = {}
        self.compute_map = True
        self.save_plots = False
        self.outdir = "."
        self.outfilename_completeness = "completeness.csv"
        self.outfilename_reliability = "reliability.csv"

        # aggregates (reference: mrcnn/analyze.py:87-121)
        c = self.n_classes
        self.classification_matrix = np.zeros((c, c), dtype=np.float64)
        self.nobjs_true = np.zeros(c, dtype=np.int64)
        self.nobjs_det = np.zeros(c, dtype=np.int64)
        self.nobjs_det_right = np.zeros(c, dtype=np.int64)
        self.completeness_dict_list: List[Dict] = []
        self.reliability_dict_list: List[Dict] = []

        # mAP accumulators
        self._map_values: List[float] = []
        self._voc_gts: List[VOC.BBox] = []
        self._voc_dets: List[VOC.BBox] = []
        self._coco_gt: Dict[str, List] = {}
        self._coco_pred: Dict[str, Dict] = {}
        self._mc_json: Dict[str, Dict] = {}

    # ---------------------------------------------------------------- run
    def test(self) -> int:
        """Evaluate every dataset image (reference: mrcnn/analyze.py:123-185).

        Unlike the reference's strictly batch-1 evaluation loop, images are
        detected in device-batch-sized groups (all images mold to the same
        static shape), with per-image post-processing unchanged.
        """
        image_ids = list(self.dataset.image_ids)
        if self.n_max_img > 0:
            image_ids = image_ids[: self.n_max_img]
        bs = max(getattr(self.detector, "config", self.config).batch_size, 1)
        done = 0
        for start in range(0, len(image_ids), bs):
            group = image_ids[start : start + bs]
            try:
                images = [self.dataset.load_image(i) for i in group]
            except Exception:
                logger.exception("Failed to load batch starting at %s", group[0])
                continue
            results = self.detector.detect(images)  # raises: see the module docstring
            for image_id, image, r in zip(group, images, results):
                try:
                    self.inspect_image(image_id, image=image, result=r)
                except Exception:
                    logger.exception("Failed to evaluate image %s", image_id)
                done += 1
                if done % 10 == 0:
                    logger.info("evaluated %d/%d images", done, len(image_ids))
        self.compute_performances()
        if self.compute_map:
            self.compute_mAP()
        return 0

    # --------------------------------------------------------- per image
    def inspect_image(self, image_id, image=None, result=None) -> None:
        ds = self.dataset
        cfg = self.config
        if image is None:
            image = ds.load_image(image_id)
        gt_masks_raw, gt_class_ids_raw = ds.load_mask(image_id)
        image_path = ds.image_reference(image_id)
        metadata = ds.image_metadata(image_id) if hasattr(ds, "image_metadata") else {}
        obj_info = ds.load_gt_obj_info(image_id) if hasattr(ds, "load_gt_obj_info") else []

        # detect + post-process
        r = result if result is not None else self.detector.detect([image])[0]
        an = self.analyzer
        an.image = image
        an.image_id = image_id
        an.image_metadata = metadata
        an.extract_det_masks(r["masks"], r["class_ids"], r["scores"])
        if self.classid_remap_dict:
            an.class_ids_final = [
                self.classid_remap_dict.get(c, c) for c in an.class_ids_final
            ]
            an.class_names_final = [
                self.class_names[c] if 0 <= c < len(self.class_names) else str(c)
                for c in an.class_ids_final
            ]

        # GT merge + matching
        gt_masks, gt_ids, gt_members = extract_gt_masks(gt_masks_raw, gt_class_ids_raw)
        ev = evaluate_image(
            gt_masks,
            gt_ids,
            an.masks_final,
            an.class_ids_final,
            an.scores_final,
            self.class_names,
            iou_thr=self.iou_thr,
        )

        # aggregate (reference: mrcnn/analyze.py:190-207)
        self.classification_matrix += ev.confusion_matrix
        self.nobjs_true += ev.nobjs_true
        self.nobjs_det += ev.nobjs_det
        self.nobjs_det_right += ev.nobjs_det_right

        # completeness rows (per GT object, reference: mrcnn/analyze.py:209-266)
        tel = metadata.get("telescope", "")
        rms = metadata.get("rms", "")
        bkg = metadata.get("bkg", "")
        for i in range(len(gt_masks)):
            obj = obj_info[gt_members[i][0]] if gt_members[i] and len(obj_info) > gt_members[i][0] else {}
            d = collections.OrderedDict()
            d["img"] = image_path
            d["telescope"] = tel
            d["img_rms"] = rms
            d["img_bkg"] = bkg
            d["sname"] = obj.get("name", f"G{i + 1}")
            d["class_id"] = gt_ids[i]
            d["class_name"] = (
                self.class_names[gt_ids[i]] if gt_ids[i] < len(self.class_names) else ""
            )
            d["class_id_det"] = ev.detobj_classids[i]
            d["class_name_det"] = ev.detobj_class_names[i]
            d["detected"] = int(ev.is_gt_obj_detected[i])
            d["score"] = ev.detobj_scores[i]
            d["iou"] = ev.detobj_ious[i]
            d["snr"] = float(obj.get("snr", -999))
            d["maxBeamSize"] = float(obj.get("maxsize_beam", -999))
            min_beam = float(obj.get("minsize_beam", 0) or 0)
            d["aspectRatio"] = (
                d["maxBeamSize"] / min_beam if min_beam > 0 else -999
            )
            d["border"] = int(obj.get("border", 0))
            self.completeness_dict_list.append(d)

        # reliability rows (per detected object, reference:
        # mrcnn/analyze.py:268-316)
        for j in range(len(an.masks_final)):
            d = collections.OrderedDict()
            d["img"] = image_path
            d["telescope"] = tel
            d["img_rms"] = rms
            d["img_bkg"] = bkg
            d["sname"] = f"S{j + 1}_det"
            d["class_id_det"] = an.class_ids_final[j]
            d["class_name_det"] = an.class_names_final[j]
            d["class_id"] = ev.matchobj_classids[j]
            d["class_name"] = ev.matchobj_class_names[j]
            d["matching_gt"] = int(ev.is_det_obj_matching_to_gt_obj[j])
            d["score"] = float(an.scores_final[j])
            d["iou"] = float(ev.matchobj_ious[j])
            d["snr"] = float(an.obj_pars[j].get("SNR", -999)) if j < len(an.obj_pars) else -999
            d["maxBeamSize"] = -999
            d["aspectRatio"] = -999
            d["border"] = 0
            self.reliability_dict_list.append(d)

        self.save()

        # mAP bookkeeping
        if self.compute_map:
            self._accumulate_map(image_id, image_path, gt_masks_raw, gt_class_ids_raw, r)

    # ------------------------------------------------------------- tables
    def save(self) -> None:
        """Rewrite CSV tables (reference: mrcnn/analyze.py:328-351)."""
        for rows, fname in (
            (self.completeness_dict_list, self.outfilename_completeness),
            (self.reliability_dict_list, self.outfilename_reliability),
        ):
            if not rows:
                continue
            path = os.path.join(self.outdir, fname)
            with open(path, "w") as fp:
                fp.write("# ")
                writer = csv.DictWriter(fp, rows[0].keys())
                writer.writeheader()
                writer.writerows(rows)

    def compute_performances(self) -> Dict:
        """Normalize + report the aggregate matrices
        (reference: mrcnn/analyze.py:356-406)."""
        c = self.n_classes
        norm = np.zeros_like(self.classification_matrix)
        for i in range(c):
            row_sum = self.classification_matrix[i].sum()
            if row_sum > 0:
                norm[i] = self.classification_matrix[i] / row_sum
        completeness = np.divide(
            self.nobjs_det_right,
            np.maximum(self.nobjs_true, 1),
            where=self.nobjs_true > 0,
        )
        reliability = np.divide(
            self.nobjs_det_right,
            np.maximum(self.nobjs_det, 1),
            where=self.nobjs_det > 0,
        )
        logger.info("classification matrix (normalized):\n%s", norm)
        logger.info("completeness per class: %s", completeness)
        logger.info("reliability per class: %s", reliability)
        return {
            "classification_matrix": self.classification_matrix,
            "classification_matrix_norm": norm,
            "completeness": completeness,
            "reliability": reliability,
        }

    # --------------------------------------------------------------- mAP
    def _accumulate_map(self, image_id, image_path, gt_masks, gt_class_ids, r) -> None:
        """Collect matterport AP + the three dump formats
        (reference: mrcnn/analyze.py:408-575)."""
        img_key = os.path.splitext(os.path.basename(image_path or str(image_id)))[0]
        gt_boxes = extract_bboxes(gt_masks) if gt_masks.size else np.zeros((0, 4))
        ap = AP.compute_ap(
            gt_boxes,
            np.asarray(gt_class_ids),
            gt_masks,
            r["rois"].astype(np.float64) if len(r["rois"]) else np.zeros((0, 4)),
            r["class_ids"],
            r["scores"],
            r["masks"],
            iou_threshold=0.5,
        )[0]
        self._map_values.append(float(ap))

        # Padilla format (y1x1y2x2 -> x1y1x2y2)
        for i in range(gt_boxes.shape[0]):
            y1, x1, y2, x2 = gt_boxes[i]
            cname = self.class_names[gt_class_ids[i]]
            self._voc_gts.append(VOC.BBox(img_key, cname, (x1, y1, x2, y2)))
        for i in range(len(r["class_ids"])):
            y1, x1, y2, x2 = r["rois"][i]
            cname = self.class_names[r["class_ids"][i]]
            self._voc_dets.append(
                VOC.BBox(img_key, cname, (x1, y1, x2, y2), float(r["scores"][i]))
            )
        # tarlen5 format
        self._coco_gt[img_key] = [
            [float(b[1]), float(b[0]), float(b[3]), float(b[2])] for b in gt_boxes
        ]
        self._coco_pred[img_key] = {
            "boxes": [
                [float(b[1]), float(b[0]), float(b[3]), float(b[2])] for b in r["rois"]
            ],
            "scores": [float(s) for s in r["scores"]],
        }
        # SKA-INAF metric-computation format (reference: mrcnn/analyze.py:532-575)
        self._mc_json[img_key] = {
            "gt_boxes": [
                [float(b[1]), float(b[0]), float(b[3]), float(b[2])] for b in gt_boxes
            ],
            "gt_labels": [int(c) for c in gt_class_ids],
            "det_boxes": [
                [float(b[1]), float(b[0]), float(b[3]), float(b[2])] for b in r["rois"]
            ],
            "det_labels": [int(c) for c in r["class_ids"]],
            "det_scores": [float(s) for s in r["scores"]],
        }

    def compute_mAP(self) -> Dict:
        out: Dict = {}
        out["matterport_mAP@0.5"] = float(np.mean(self._map_values)) if self._map_values else 0.0
        voc = VOC.pascal_voc_metrics(self._voc_gts, self._voc_dets, iou_threshold=0.5)
        out["voc"] = {
            k: (v["AP"] if isinstance(v, dict) else v) for k, v in voc.items()
        }
        out["coco"] = COCO.coco_map(self._coco_gt, self._coco_pred)

        # dumps for the external tools
        VOC.write_padilla_dirs(
            self._voc_gts,
            self._voc_dets,
            os.path.join(self.outdir, "groundtruths"),
            os.path.join(self.outdir, "detections"),
        )
        COCO.write_box_jsons(
            self._coco_gt,
            self._coco_pred,
            os.path.join(self.outdir, "ground_truth_boxes.json"),
            os.path.join(self.outdir, "predicted_boxes.json"),
        )
        with open(os.path.join(self.outdir, "metric_computation_input.json"), "w") as f:
            json.dump(self._mc_json, f, indent=2, cls=NumpyEncoder)
        with open(os.path.join(self.outdir, "map_summary.json"), "w") as f:
            json.dump(out, f, indent=2, cls=NumpyEncoder)
        logger.info("mAP summary: %s", {k: v for k, v in out.items() if k != "coco"})
        return out
