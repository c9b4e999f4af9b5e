"""Ahead-of-time export of the detect graph for serving (port of
``caesar_mrcnn_tpu/inference/export.py``).

``torch.export`` takes the place of ``jax.export``: the detector's
weights, anchors, canonical image metas and box std-devs are baked into
one artifact (``torch.export.save``), so a server loads the whole detector
without the model code, the config object or a checkpoint; a JSON sidecar
carries the molding metadata (image shape, classes, batch) that drives it.
The graph holds ATen operators and the ``caesar::*`` operators of the
port's kernels (``ops/library.py``): on the card those nodes run the
hand-written kernels, on the CPU their plain versions. An artifact runs on
the kind of device it was exported on.

Where the port differs from the JAX package: a detector configured for
int8 (``quant_mode="int8"``) without an int8 graph for its current weights
is refused (the JAX package exports its float graph then, and writes
``quant_mode: "none"``); calibrate it first with ``Detector.quantize``.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import logger
from .. import ops  # noqa: F401  (registers the caesar operators the artifact calls)
from ..utils import boxes as B
from ..utils import image as I


def export_detector(detector, path: str) -> None:
    """Export ``detector``'s detect graph to ``path``.

    Writes ``<path>`` (a ``torch.export`` artifact, weights baked in) and
    ``<path>.json`` (molding metadata): :func:`save_artifact` of
    :func:`export_program`.
    """
    save_artifact(*export_program(detector), path)


def export_program(detector) -> Tuple[torch.export.ExportedProgram, Dict]:
    """(exported program, sidecar) of ``detector``'s detect graph.

    The program takes ONE argument, molded images ``[B, H, W, C] float32``
    on the detector's device, and returns ``(detections [B, D, 6], masks
    [B, D, mh, mw])``; image metas and anchors are baked for the canonical
    full-window molding, matching ``Detector.detect`` on images already at
    the model's input size. The graph is the one ``Detector._step`` runs:
    the int8 stages where the detector has them for its current weights,
    else the float model. Traced outside inference mode (no gradient), with
    static shapes.
    """
    from torch import nn

    from ..models.mask_rcnn import forward_inference
    from ..models.meta import compose_image_meta

    cfg = detector.config
    b = cfg.batch_size
    h, w, c = cfg.image_shape
    stages = detector.int8_graph()
    if cfg.quant_mode == "int8" and stages is None:
        raise ValueError("export_detector: the detector is configured for int8 but has no int8 graph for its "
                         "current weights; calibrate it first with Detector.quantize(images)")
    dev = detector.device
    metas = np.stack([compose_image_meta(i, (h, w, c), (h, w, c), (0, 0, h, w), 1.0, np.zeros(cfg.num_classes))
                      for i in range(b)]).astype(np.float32)
    anchors, _ = detector._constants((h, w, c))

    class DetectGraph(nn.Module):
        """The detect graph with its constants as buffers."""

        def __init__(self):
            super().__init__()
            self.model = detector.model if stages is None else stages
            self.register_buffer("anchors", anchors)
            self.register_buffer("metas", torch.from_numpy(metas).to(dev))
            self.register_buffer("rpn_std", detector._rpn_std)
            self.register_buffer("bbox_std", detector._bbox_std)

        def forward(self, images):
            out = forward_inference(self.model, images, self.metas, self.anchors, self.rpn_std, self.bbox_std)
            return out.detections, out.masks

    example = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    with torch.no_grad():
        program = torch.export.export(DetectGraph().eval(), (example,), strict=False)
    sidecar = {
        "image_shape": [h, w, c],
        "batch_size": b,
        "num_classes": cfg.num_classes,
        "class_names": list(cfg.class_names),
        "detection_max_instances": cfg.detection_max_instances,
        "mask_wire_dtype": cfg.mask_wire_dtype,
        "mean_pixel": list(cfg.mean_pixel),
        "device": dev.type,
        "torch_version": torch.__version__,
        "quant_mode": "int8" if stages is not None else "none",
    }
    return program, sidecar


def save_artifact(program: torch.export.ExportedProgram, sidecar: Dict, path: str) -> None:
    """Write ``program`` to ``path`` (``torch.export.save``) and ``sidecar``
    to ``<path>.json``."""
    torch.export.save(program, path)
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    h, w, _ = sidecar["image_shape"]
    logger.info("exported detect graph (%d-batch %dx%d, %d classes, %s) -> %s (%.1f MB)", sidecar["batch_size"],
                h, w, sidecar["num_classes"], sidecar["quant_mode"], path, os.path.getsize(path) / 1e6)


def caesar_nodes(program) -> Dict[str, int]:
    """{operator: count} of the port's kernel operators (``caesar::*``) in
    an exported program's graph."""
    counts = collections.Counter(
        node.target.name().split("::")[1].split(".")[0] for node in program.graph.nodes
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == ops.library.NAMESPACE)
    return dict(counts)


class ServingDetector:
    """Standalone detector backed by an exported artifact: no model code,
    config object or checkpoint needed. API mirrors ``Detector.detect``
    for images already at the artifact's input size. It runs on ``device``,
    the card unless the caller asks for another, which must be the kind of
    device the artifact was exported on."""

    def __init__(self, path: str, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingDetector: no CUDA device is available (pass device='cpu' for an artifact "
                               "exported on the CPU)")
        with open(path + ".json") as f:
            self.meta: Dict = json.load(f)
        if self.meta["device"] != self.device.type:
            raise ValueError(f"{path} was exported on {self.meta['device']} and runs there, not on {self.device}")
        self.program = torch.export.load(path)
        self._module = self.program.module()

    @property
    def batch_size(self) -> int:
        return int(self.meta["batch_size"])

    @property
    def class_names(self) -> List[str]:
        return list(self.meta["class_names"])

    def _call(self, molded: np.ndarray):
        """The exported program on one molded batch: (detections, masks)
        as host arrays."""
        with torch.no_grad():
            detections, masks = self._module(torch.from_numpy(molded).to(self.device))
        return detections.cpu().numpy(), masks.cpu().numpy()

    def detect(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """images: list of [H, W, C] float arrays at the exported size.
        Returns the Detector-style per-image dicts (rois in pixel coords,
        class_ids, scores, masks [H, W, N] at the input size)."""
        b = self.batch_size
        h, w, c = self.meta["image_shape"]
        n = len(images)
        if n == 0 or n > b:
            raise ValueError(f"expected 1..{b} images, got {n}")
        mean = np.asarray(self.meta["mean_pixel"], np.float32)
        molded = np.stack([np.asarray(im, np.float32) - mean for im in images])
        if molded.shape[1:] != (h, w, c):
            raise ValueError(f"images must be pre-sized to {(h, w, c)}, got {molded.shape[1:]}: use the full "
                             f"Detector for molding")
        if n < b:  # pad the tail to the exported batch
            molded = np.concatenate([molded, np.repeat(molded[-1:], b - n, axis=0)])
        detections, masks = self._call(molded)
        if self.meta["mask_wire_dtype"] == "uint8":
            masks = masks.astype(np.float32) / 255.0

        results = []
        for i in range(n):
            det = detections[i]
            # padded suffix convention: the first class-0 slot ends the list
            zero_ix = np.where(det[:, 4] == 0)[0]
            k = zero_ix[0] if zero_ix.shape[0] > 0 else det.shape[0]
            boxes = B.denorm_boxes(det[:k, :4], (h, w))
            class_ids = det[:k, 4].astype(np.int32)
            scores = det[:k, 5].astype(np.float32)
            m = masks[i, :k]
            # drop boxes that collapse to zero pixel area after denorm
            # rounding, as Detector.unmold_detections does: a mask cannot be
            # resized to an empty box
            keep = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0
            boxes, class_ids, scores, m = boxes[keep], class_ids[keep], scores[keep], m[keep]
            # unmold_mask's paste, into one preallocated [H, W, N] frame
            # (as Detector.unmold_detections: stacking N separate frames
            # costs about a millisecond per detection at 512^2)
            full = np.zeros((h, w, boxes.shape[0]), dtype=bool)
            for j in range(boxes.shape[0]):
                I.paste_mask(m[j], boxes[j], full[..., j])
            results.append({"rois": boxes, "class_ids": class_ids, "scores": scores, "masks": full})
        return results
