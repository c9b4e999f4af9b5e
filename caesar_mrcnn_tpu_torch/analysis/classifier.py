"""Cutout-based classification of pre-detected sources.

Re-design of the reference ``SClassifier`` (reference:
mrcnn/classifier.py:79-465): given a FITS image and an ascii (Caesar-style)
source catalog, cut a fixed-size cutout around each unvisited source, run
detection on it, match detections to catalog sources by bbox IoU, and
attach classification info. Sources fully contained in a processed cutout
are marked visited so overlapping cutouts don't re-classify them
(reference: mrcnn/classifier.py:281-287).

The port's copy of ``caesar_mrcnn_tpu/analysis/classifier.py``, with the
same outputs. It reaches the detector only through
``detector.detect([cutout])``: one cutout per call, at inference batch 1
(the JAX module's docstring speaks of device-batch groups, which its code
does not form either). The match keeps the last detection on an IoU tie,
so the detections come in the order the ``Analyzer`` gives them.

One deliberate difference: a cutout whose window starts left of or above
the image is clamped to the image, as the right and bottom edges already
are, and the cutout's sources are placed relative to the clamped origin.
The JAX package's crop wraps there to an empty slice and raises; a window
wholly off the image gives an empty cutout, which ``run`` skips.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import logger
from ..config import Config
from ..utils import fits as F


@dataclass
class SClassInfo:
    """Classification attached to a source
    (reference: mrcnn/classifier.py:40-48)."""

    class_id: int = -1
    class_name: str = ""
    score: float = 0.0
    snames: List[str] = field(default_factory=list)


@dataclass
class SData:
    """Catalog source (reference: mrcnn/classifier.py:53-74)."""

    name: str = ""
    x0: float = -1.0
    y0: float = -1.0
    xmin: float = -1.0
    xmax: float = -1.0
    ymin: float = -1.0
    ymax: float = -1.0
    visited: bool = False
    class_info: List[SClassInfo] = field(default_factory=list)


def _bbox_iou(b1, b2) -> float:
    """(y1, x1, y2, x2) box IoU (reference get_iou: mrcnn/utils.py:100-145)."""
    y_top = max(b1[0], b2[0])
    x_left = max(b1[1], b2[1])
    y_bot = min(b1[2], b2[2])
    x_right = min(b1[3], b2[3])
    if x_right < x_left or y_bot < y_top:
        return 0.0
    inter = (x_right - x_left) * (y_bot - y_top)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    return inter / float(a1 + a2 - inter)


class SClassifier:
    def __init__(self, detector, config: Config):
        self.detector = detector
        self.config = config
        self.class_names = list(config.class_names)
        self.scutout_size = 132  # reference default (mrcnn/classifier.py:106)
        self.iou_thr = config.iou_thr
        self.score_thr = config.score_thr
        self.n_max_sources = -1

        self.image_path = ""
        self.img_data: Optional[np.ndarray] = None
        self.img_header: Optional[Dict] = None
        self.sources: List[SData] = []

    # ------------------------------------------------------------- input
    def read_img(self, image_path: str) -> int:
        out = F.read_fits(image_path, stretch=False, normalize=False, convert_to_rgb=False)
        if out is None:
            logger.error("Failed to read image %s!", image_path)
            return -1
        self.image_path = image_path
        self.img_data, self.img_header = out
        return 0

    def read_scatalog(self, path: str) -> int:
        """ascii catalog rows with name at col 0, centroid at cols 5/6 and
        bbox at cols 13-16 (reference: mrcnn/classifier.py:403-431)."""
        self.sources = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split()
                if len(cols) < 17:
                    continue
                self.sources.append(
                    SData(
                        name=cols[0],
                        x0=float(cols[5]),
                        y0=float(cols[6]),
                        xmin=float(cols[13]),
                        xmax=float(cols[14]),
                        ymin=float(cols[15]),
                        ymax=float(cols[16]),
                    )
                )
        logger.info("Read #%d sources from %s", len(self.sources), path)
        return 0 if self.sources else -1

    # ------------------------------------------------------------ cutout
    def _window(self, src: SData) -> Tuple[int, int, int, int]:
        """The cutout's window (xmin, ymin, xmax, ymax) around a source; it
        may reach past the image on any side."""
        d = self.scutout_size
        return int(src.x0 - d / 2), int(src.y0 - d / 2), int(src.x0 + d / 2), int(src.y0 + d / 2)

    def _make_cutout(self, src: SData) -> np.ndarray:
        """Preprocessed RGB cutout around a source
        (reference: mrcnn/classifier.py:211-222 via utils.crop_img), its
        window clamped to the image. Empty when the window misses it."""
        xmin, ymin, xmax, ymax = (max(v, 0) for v in self._window(src))
        data = self.img_data[ymin:ymax, xmin:xmax]
        if data.size == 0:
            return np.zeros((0, 0, 3), np.float32)
        h, w = data.shape
        return F.crop_img(data, w / 2, h / 2, w, h, stretch=True, normalize=True, convert_to_rgb=True)

    def _sources_in_cutout(self, src_index: int) -> Tuple[List[int], List, List[bool]]:
        """Catalog sources whose centroid falls inside this cutout's window,
        with bboxes relative to the cutout's (clamped) origin and cut flags
        (reference: mrcnn/classifier.py:237-276)."""
        xmin, ymin, xmax, ymax = self._window(self.sources[src_index])
        ox, oy = max(xmin, 0), max(ymin, 0)

        indices, bboxes, cut_flags = [], [], []
        for j, other in enumerate(self.sources):
            if j != src_index:
                if not (xmin < other.x0 < xmax and ymin < other.y0 < ymax):
                    continue
            indices.append(j)
            bboxes.append([other.ymin - oy, other.xmin - ox, other.ymax - oy, other.xmax - ox])
            cut = (
                other.xmin <= xmin or other.xmax >= xmax
                or other.ymin <= ymin or other.ymax >= ymax
            )
            cut_flags.append(bool(cut))
        return indices, bboxes, cut_flags

    # --------------------------------------------------------------- run
    def run(self, image_path: str, scatalog_path: str) -> int:
        """Classify every catalog source (reference: mrcnn/classifier.py:117-150)."""
        if self.read_img(image_path) < 0:
            return -1
        if self.read_scatalog(scatalog_path) < 0:
            return -1

        from .analyzer import Analyzer

        analyzer = Analyzer(self.detector, self.config)
        analyzer.score_thr = self.score_thr
        analyzer.write_to_json = False
        analyzer.write_to_ds9 = False

        n_done = 0
        for sindex in range(len(self.sources)):
            if self.n_max_sources > 0 and n_done >= self.n_max_sources:
                break
            src = self.sources[sindex]
            if src.visited:
                continue
            n_done += 1

            cutout = self._make_cutout(src)
            if cutout.size == 0:
                logger.warning("Empty cutout for source %s, skipping", src.name)
                continue
            indices, bboxes, cut_flags = self._sources_in_cutout(sindex)

            r = self.detector.detect([cutout])[0]
            analyzer.image = cutout
            analyzer.image_id = src.name
            analyzer.extract_det_masks(r["masks"], r["class_ids"], r["scores"])
            det_bboxes = analyzer.bboxes
            det_scores = analyzer.scores_final
            det_classids = analyzer.class_ids_final

            # match each cutout source to its best-IoU detection
            association: Dict[int, List[int]] = {}
            best_det: List[int] = []
            for j, bbox_s in enumerate(bboxes):
                i_best, iou_best = -1, 0.0
                for i, bbox_d in enumerate(det_bboxes):
                    iou = _bbox_iou(bbox_d, bbox_s)
                    if iou > self.iou_thr and iou >= iou_best:
                        i_best, iou_best = i, iou
                best_det.append(i_best)
                if i_best != -1:
                    association.setdefault(i_best, []).append(indices[j])

            for j, idx in enumerate(indices):
                if not cut_flags[j]:
                    self.sources[idx].visited = True
                i_best = best_det[j]
                if i_best == -1:
                    continue
                info = SClassInfo(
                    class_id=int(det_classids[i_best]),
                    class_name=self.class_names[det_classids[i_best]],
                    score=float(det_scores[i_best]),
                    snames=[
                        self.sources[k].name
                        for k in association[i_best]
                        if k != idx
                    ],
                )
                self.sources[idx].class_info.append(info)
        return 0

    # ------------------------------------------------------------ output
    def write_catalog(self, outfile: str) -> None:
        """ascii output: name, position, best class/score."""
        with open(outfile, "w") as f:
            f.write("# name x0 y0 class_id class_name score\n")
            for s in self.sources:
                if s.class_info:
                    best = max(s.class_info, key=lambda c: c.score)
                    f.write(
                        f"{s.name} {s.x0} {s.y0} {best.class_id} {best.class_name} {best.score:.4f}\n"
                    )
                else:
                    f.write(f"{s.name} {s.x0} {s.y0} -1 unclassified 0.0\n")
