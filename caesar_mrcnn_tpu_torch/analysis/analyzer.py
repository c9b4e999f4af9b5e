"""Per-image detection post-processing & evaluation engine.

Re-design of the reference ``Analyzer`` (reference: mrcnn/analyze.py:580-2175):

* score-threshold selection + descending-score sort
  (reference: mrcnn/analyze.py:1174-1204);
* optional split of non-connected components, skipped for extended
  classes (reference: mrcnn/analyze.py:1211-1243);
* merge of connected same-class masks with IoU >= merge threshold via
  union-find (reference: mrcnn/analyze.py:1262-1311);
* overlapping different-class resolution via networkx max-cliques keeping
  the highest score, with the spurious-vs-other IoU exception
  (reference: mrcnn/analyze.py:1326-1423);
* per-object morphological parameters via OpenCV (contours, minAreaRect,
  moments) + SNR from image metadata (reference: mrcnn/analyze.py:1502-1676);
* per-image confusion matrix / completeness / purity via mask-IoU matching
  (reference: mrcnn/analyze.py:1682-1860);
* JSON catalog with pixel lists + contour vertices
  (reference: mrcnn/analyze.py:1866-1955), DS9 regions, PNG overlays.

The O(N^2) connectivity hot loop is replaced by bbox-gated scipy/OpenCV
morphology (analysis/masks.py).

The port's copy of ``caesar_mrcnn_tpu/analysis/analyzer.py``, with the same
outputs. It uses no networkx, OpenCV or matplotlib: the cliques come from
``utils/graph.py::find_cliques`` (networkx's algorithm, in its order), the
contours, ``minAreaRect`` and moments from ``analysis/contours.py``.
Drawing (``draw`` with ``outfile_img``) needs matplotlib and waits for
ROADMAP item A16c: :meth:`Analyzer.predict` raises ``NotImplementedError``
where the JAX package would draw.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import logger
from ..config import Config
from ..utils.boxes import extract_bboxes
from . import masks as M
from .contours import min_area_rect, moments
from .regions import make_regions_from_objs, write_ds9_regions
from ..utils.graph import Graph, find_cliques

# classes never split into components (reference: mrcnn/analyze.py:1222-1227)
NO_SPLIT_CLASSES = {"galaxy_C2", "galaxy_C3", "galaxy", "extended-multisland", "extended"}


class Analyzer:
    def __init__(self, detector, config: Config, dataset=None):
        self.detector = detector
        self.config = config
        self.dataset = dataset
        self.class_names = list(config.class_names)

        # post-processing knobs (reference defaults: mrcnn/analyze.py:600-720)
        self.score_thr = config.score_thr
        # per-class overrides (config.score_thr_per_class; absent classes
        # fall back to self.score_thr — which stays mutable for callers
        # like SClassifier that override the global threshold)
        self.score_thr_per_class = dict(
            getattr(config, "score_thr_per_class", ()) or ()
        )
        self.iou_thr = config.iou_thr
        self.split_masks = True
        self.merge_overlapped_masks = True
        self.select_best_overlapped_masks = True
        self.split_source_sidelobe = True
        self.merge_overlap_iou_thr = 0.3
        self.obj_name_tag = "det"

        # outputs
        self.draw = False
        self.write_to_json = True
        self.write_to_ds9 = True
        self.outfile_json = ""
        self.outfile_ds9 = ""
        self.outfile_img = ""

        # tile origin offsets for mosaic work (reference tile path,
        # mrcnn/analyze.py:1891-1905)
        self.image_xmin = 0
        self.image_ymin = 0

        # per-call state
        self.image: Optional[np.ndarray] = None
        self.image_id = 0
        self.image_header: Optional[Dict] = None
        self.image_metadata: Dict = {}
        self.results: Dict = {}
        self.masks_final: List[np.ndarray] = []
        self.class_ids_final: List[int] = []
        self.class_names_final: List[str] = []
        self.scores_final: List[float] = []
        self.bboxes: List = []
        self.obj_pars: List[Dict] = []
        self.timing: Dict[str, float] = {}

    # =================================================================
    # ==  POST-PROCESSING PIPELINE
    # =================================================================
    def extract_det_masks(
        self, masks: np.ndarray, class_ids: np.ndarray, scores: np.ndarray
    ) -> None:
        """Threshold -> split -> merge -> best-overlap select -> finalize."""
        self.masks_final = []
        self.class_ids_final = []
        self.class_names_final = []
        self.scores_final = []
        self.bboxes = []

        # 1. score threshold, per-class-capable (reference single global
        # threshold: mrcnn/analyze.py:1174-1199 + analyze.py:1744)
        def _thr(cid: int) -> float:
            name = (
                self.class_names[cid]
                if cid < len(self.class_names)
                else str(cid)
            )
            return self.score_thr_per_class.get(name, self.score_thr)

        sel = [
            (masks[:, :, i].astype(np.uint8), int(class_ids[i]), float(scores[i]))
            for i in range(masks.shape[-1])
            if scores[i] >= _thr(int(class_ids[i]))
        ]
        # 2. sort by descending score
        sel.sort(key=lambda t: -t[2])

        # 3. split non-connected components (skip extended classes)
        det: List[Tuple[np.ndarray, int, float]] = []
        for mask, cid, score in sel:
            label = self.class_names[cid] if cid < len(self.class_names) else str(cid)
            if not self.split_masks or label in NO_SPLIT_CLASSES:
                det.append((mask, cid, score))
                continue
            for comp in M.split_mask_components(mask):
                det.append((comp, cid, score))

        # 4. merge connected same-class masks with IoU >= threshold
        if self.merge_overlapped_masks and det:
            n = len(det)
            bbs = [M.mask_bbox(m) for m, _, _ in det]
            g = Graph(n)
            for i in range(n):
                for j in range(i + 1, n):
                    if det[i][1] != det[j][1]:
                        continue
                    if not M.bboxes_adjacent(bbs[i], bbs[j], gap=2):
                        continue
                    if not M.are_masks_connected(det[i][0], det[j][0], bbs[i], bbs[j]):
                        continue
                    if M.mask_iou(det[i][0], det[j][0]) >= self.merge_overlap_iou_thr:
                        g.addEdge(i, j)
            merged: List[Tuple[np.ndarray, int, float]] = []
            for comp in g.connectedComponents():
                if not comp:
                    continue
                mask = det[comp[0]][0]
                score_sum = det[comp[0]][2]
                for idx in comp[1:]:
                    mask = M.merge_masks(mask, det[idx][0])
                    score_sum += det[idx][2]
                merged.append((mask, det[comp[0]][1], score_sum / len(comp)))
        else:
            merged = det

        # 5. best-overlap selection via max cliques
        if self.select_best_overlapped_masks and merged:
            n = len(merged)
            bbs = [M.mask_bbox(m) for m, _, _ in merged]
            adj: Dict[int, List[int]] = {i: [] for i in range(n)}
            for i in range(n):
                label_i = self.class_names[merged[i][1]]
                for j in range(i + 1, n):
                    label_j = self.class_names[merged[j][1]]
                    if not M.bboxes_adjacent(bbs[i], bbs[j], gap=2):
                        continue
                    if not M.are_masks_connected(merged[i][0], merged[j][0], bbs[i], bbs[j]):
                        continue
                    mergeable = True
                    spurious_other = (label_i in ("spurious", "sidelobe")) != (
                        label_j in ("spurious", "sidelobe")
                    )
                    if self.split_source_sidelobe and spurious_other:
                        if M.mask_iou(merged[i][0], merged[j][0]) < self.merge_overlap_iou_thr:
                            mergeable = False
                    if mergeable:
                        adj[i].append(j)
                        adj[j].append(i)

            cliques = [c for c in find_cliques(adj) if len(c) > 1]
            clique_best = [max(c, key=lambda k: merged[k][2]) for c in cliques]
            order = sorted(
                range(len(cliques)), key=lambda k: -merged[clique_best[k]][2]
            )
            selected = [True] * n
            for ci in order:
                best = clique_best[ci]
                for idx in cliques[ci]:
                    if idx != best:
                        selected[idx] = False
            final = [m for i, m in enumerate(merged) if selected[i]]
        else:
            final = merged

        # 6. bbox + integrity check (reference: mrcnn/analyze.py:1430-1456)
        for mask, cid, score in final:
            bbox = extract_bboxes(mask[:, :, None].astype(bool))[0]
            if bbox[1] >= bbox[3] or bbox[0] >= bbox[2]:
                continue
            self.masks_final.append(mask)
            self.class_ids_final.append(cid)
            self.class_names_final.append(self.class_names[cid])
            self.scores_final.append(score)
            self.bboxes.append(bbox)

    # =================================================================
    # ==  OBJECT PARAMETERS
    # =================================================================
    def compute_obj_pars(self, raw_image: Optional[np.ndarray] = None) -> List[Dict]:
        """Morphological + photometric parameters per final object
        (reference: mrcnn/analyze.py:1502-1676)."""
        self.obj_pars = []
        meta = self.image_metadata or {}
        bkg = float(meta.get("bkg") or 0.0)
        rms = float(meta.get("rms") or 0.0)
        bmaj = meta.get("bmaj")
        bmin = meta.get("bmin")
        dx = meta.get("dx")
        dy = meta.get("dy")
        for i, mask in enumerate(self.masks_final):
            pars: Dict = {
                "class_id": int(self.class_ids_final[i]),
                "class_name": self.class_names_final[i],
                "score": float(self.scores_final[i]),
            }
            npix = int(mask.sum())
            pars["npix"] = npix
            contours = M.find_contours_xy(mask)
            pars["ncontours"] = len(contours)
            if contours:
                c = max(contours, key=len).astype(np.float32)
                rect = min_area_rect(c)
                (cx, cy), (w_r, h_r), angle = rect
                pars["minAreaRect"] = {
                    "center": [float(cx), float(cy)],
                    "size": [float(w_r), float(h_r)],
                    "angle": float(angle),
                }
                mom = moments(c)
                if mom["m00"] != 0:
                    pars["centroid"] = [mom["m10"] / mom["m00"], mom["m01"] / mom["m00"]]
            # photometry on the raw image
            if raw_image is not None and npix > 0:
                vals = raw_image[mask.astype(bool)]
                pars["Smax"] = float(np.nanmax(vals))
                pars["Ssum"] = float(np.nansum(vals))
                if rms > 0:
                    pars["SNR"] = float((pars["Smax"] - bkg) / rms)
            # beam-relative size (reference beam-area math,
            # mrcnn/analyze.py:1630-1660)
            if bmaj and bmin and dx and dy:
                pix_area = abs(float(dx) * float(dy))
                beam_area = np.pi * float(bmaj) * float(bmin) / (4.0 * np.log(2.0))
                npix_beam = beam_area / pix_area if pix_area > 0 else 0.0
                pars["nbeams"] = float(npix / npix_beam) if npix_beam > 0 else 0.0
            self.obj_pars.append(pars)
        return self.obj_pars

    # =================================================================
    # ==  JSON / DS9 OUTPUT
    # =================================================================
    def make_json_results(self) -> Dict:
        """Catalog dict with pixels + contour vertices
        (reference: mrcnn/analyze.py:1866-1941)."""
        self.results = {"image_id": self.image_id, "objs": []}
        if self.image is None:
            return self.results
        ny, nx = self.image.shape[:2]
        xmin, ymin = self.image_xmin, self.image_ymin
        for i, mask in enumerate(self.masks_final):
            y1, x1, y2, x2 = [int(v) for v in self.bboxes[i]]
            at_edge = (
                x1 <= 0 or x1 >= nx - 1 or x2 <= 0 or x2 >= nx - 1
                or y1 <= 0 or y1 >= ny - 1 or y2 <= 0 or y2 >= ny - 1
            )
            pixels = np.argwhere(mask == 1)
            if xmin or ymin:
                pixels = pixels + np.array([ymin, xmin])
            vertexes = []
            for c in M.find_contours_xy(mask):
                v = c + np.array([xmin, ymin], dtype=np.float64)
                vertexes.append(v.tolist())
            obj = {
                "name": f"S{i + 1}_{self.obj_name_tag}",
                "x1": xmin + x1,
                "x2": xmin + x2,
                "y1": ymin + y1,
                "y2": ymin + y2,
                "class_id": int(self.class_ids_final[i]),
                "class_name": self.class_names_final[i],
                "score": float(self.scores_final[i]),
                # kept as an [N,2] int array: catalogs with 10^5-pixel
                # extended sources choke the host GC when pixels become
                # millions of 2-element Python lists (measured 2.3 -> 13 s
                # per cross-tile merge); NumpyEncoder converts at JSON
                # write time
                "pixels": pixels,
                "vertexes": vertexes,
                "edge": bool(at_edge),
            }
            if i < len(self.obj_pars):
                obj["pars"] = self.obj_pars[i]
            self.results["objs"].append(obj)
        return self.results

    def write_json_results(self, outfile: str) -> None:
        if not self.results:
            logger.warning("Result obj dictionary is empty, nothing to write")
            return
        with open(outfile, "w") as fp:
            json.dump(self.results, fp, indent=2, sort_keys=True, cls=NumpyEncoder)

    def write_regions(self, outfile: str) -> None:
        regions = make_regions_from_objs(self.results.get("objs", []))
        write_ds9_regions(regions, outfile)

    # =================================================================
    # ==  PREDICT (detect + post-process + outputs)
    # =================================================================
    def predict(
        self,
        image: np.ndarray,
        image_id=0,
        header: Optional[Dict] = None,
        xmin: int = 0,
        ymin: int = 0,
        raw_image: Optional[np.ndarray] = None,
        metadata: Optional[Dict] = None,
    ) -> int:
        """Run detection + the full post-processing chain on one image
        (reference: mrcnn/analyze.py:833-905). Phase timings are logged as a
        percentage breakdown like the reference."""
        if self.draw and self.outfile_img:
            raise NotImplementedError(
                "Analyzer.draw: the detection overlay needs matplotlib, which the port does not "
                "use; drawing waits for ROADMAP item A16c"
            )
        t_start = time.time()
        self.image = image
        self.image_id = image_id
        self.image_header = header
        self.image_xmin = xmin
        self.image_ymin = ymin
        self.image_metadata = metadata or {}

        t0 = time.time()
        r = self.detector.detect([image])[0]
        t_detect = time.time() - t0

        t0 = time.time()
        self.extract_det_masks(r["masks"], r["class_ids"], r["scores"])
        self.compute_obj_pars(raw_image)
        self.make_json_results()
        t_post = time.time() - t0

        t0 = time.time()
        if self.write_to_json and self.outfile_json:
            self.write_json_results(self.outfile_json)
        if self.write_to_ds9 and self.outfile_ds9:
            self.write_regions(self.outfile_ds9)
        t_out = time.time() - t0

        tot = max(time.time() - t_start, 1e-9)
        self.timing = {"detect": t_detect, "postprocess": t_post, "output": t_out}
        logger.info(
            "predict image %s: %.2fs total (detect %.0f%%, post %.0f%%, out %.0f%%), %d objects",
            image_id,
            tot,
            100 * t_detect / tot,
            100 * t_post / tot,
            100 * t_out / tot,
            len(self.masks_final),
        )
        return 0


def inspect_results(analyzer: "Analyzer", tester, image_id, image_path: str = "") -> int:
    """API-parity helper mirroring the reference's per-image inspect
    (reference: mrcnn/analyze.py:907-1031): detection + GT matching +
    bookkeeping for one dataset image, delegated to ModelTester logic."""
    tester.inspect_image(image_id)
    return 0


class NumpyEncoder(json.JSONEncoder):
    """json encoder tolerant of numpy scalars/arrays
    (reference: mrcnn/sfinder.py NumpyEncoder)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)
