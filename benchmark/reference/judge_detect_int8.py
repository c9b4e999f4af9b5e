"""The comparison that decides ``correct`` for the int8 detect cell:
batches of tiles that the timed window itself produced, judged by the
plain int8 reference (:mod:`.mrcnn_int8`) on the same tiles and weights.

The reference calibrates on its own, on the calibration tiles, with the
proposals and detections its own folded float32 pass chooses there, and
runs its int8 graph at its own scales: nothing the program computed enters
the reference's arithmetic.

Two int8 graphs whose scales differ in the last bits of a float32 do not
give one pyramid: a changed scale moves an activation across a rounding
boundary here and there, and each such level feeds the next quantizer, so
that over the ResNet-101's ~100 sites the two pyramids end as far apart as
either lies from the float32 graph (a scale changed by 1e-7 relative moves
every level by ~4%, as much as int8 itself). So the backbone is judged by
how far the program's pyramid lies from the reference's folded float32 one
against how far the reference's own int8 pyramid does, and each later
stage is judged, as :mod:`.judge_detect` does, on the program's own inputs
to it: the pyramid it made in the timed window, its proposals, its
detections. The numbers compared, besides all of
:data:`.judge_detect.COMPARED` (the same numbers, read against the int8
reference on the program's pyramid, with limits of this cell's own):

* ``act_scale_rel``: the largest relative gap between the program's
  activation scale of a site and the reference's, over every site: the
  calibration;
* ``sites_mismatch``: sites the one has and the other has not (exact);
* ``pyramid_err_ratio``: the largest, over the levels P2..P6 of the judged
  batches, of the L2 distance of the program's level from the reference's
  folded float32 one over that of the reference's int8 level (1 when the
  program is as precise as the reference): a fault in the int8
  convolutions, the folding, the weights' quantization or the scales
  shows here before the heads.

Diagnostic, not compared: ``pyramid_rel``, the largest relative L2 gap of
a level between the program's pyramid and the reference's int8 one.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import judge_detect
from . import mrcnn as R
from . import mrcnn_int8 as Q

COMPARED = ("act_scale_rel", "sites_mismatch", "pyramid_err_ratio") + judge_detect.COMPARED
MISSING = 1e9  # pyramid_err_ratio of a batch whose pyramid is missing or of another shape


class _Layers:
    """The layers :mod:`.judge_detect` reads from :mod:`.mrcnn`, with the
    quantized stages taken from an int8 :class:`.mrcnn_int8.Graph`.
    ``features`` makes the reference's int8 and folded float32 pyramids of
    the batch, keeps their gaps to ``program`` (the pyramid the program
    made on it, set before each batch) in ``gaps``, and hands on the
    program's pyramid, so that the RPN and the heads are judged on it."""

    def __init__(self, graph: Q.Graph, folded: Q.Graph):
        self.graph, self.folded = graph, folded
        self.program = None
        self.gaps: List[Tuple[float, float]] = []

    def __getattr__(self, name):
        return getattr(R, name)

    def features(self, sd, cfg, images):
        own, exact = self.graph.features(images), self.folded.features(images)
        program = _on(self.program, own)
        self.gaps.append(pyramid_gaps(program, own, exact))
        return own if program is None else program

    def rpn(self, sd, pyramid):
        return self.graph.rpn(pyramid)

    def roi_align(self, levels, boxes, image_shape, pool):
        return self.graph.roi_align(levels, boxes, image_shape, pool)

    def classifier(self, sd, pooled):
        return self.graph.classifier(pooled)

    def mask_head(self, sd, pooled):
        return self.graph.mask_head(pooled)


@contextlib.contextmanager
def _int8_layers(graph: Q.Graph, folded: Q.Graph):
    """:mod:`.judge_detect` reading its layers from a :class:`_Layers` inside the block."""
    layers, saved = _Layers(graph, folded), judge_detect.R
    judge_detect.R = layers
    try:
        yield layers
    finally:
        judge_detect.R = saved


def mold(tiles: np.ndarray, cfg: Dict, device) -> torch.Tensor:
    """u8 tiles [B, H, W] -> molded NHWC float32, as the detector molds them."""
    x = torch.from_numpy(np.ascontiguousarray(tiles)).to(device).float()
    x = x[..., None].expand(-1, -1, -1, cfg["image_channel_count"])
    return x - torch.tensor(cfg["mean_pixel"], dtype=torch.float32, device=device)


def scale_gaps(program: Dict[str, float], reference: Dict[str, float]) -> Tuple[float, float]:
    """(``act_scale_rel``, ``sites_mismatch``)."""
    common = set(program) & set(reference)
    rel = max((abs(program[s] - reference[s]) / reference[s] for s in common), default=0.0)
    return float(rel), float(len(set(program) ^ set(reference)))


def _on(program: Optional[Sequence[torch.Tensor]], like: Sequence[torch.Tensor]):
    """The program's pyramid as float32 on the reference's device, its
    padding rows cut; None if it is missing or of another shape."""
    if program is None or len(program) != len(like):
        return None
    out = [p[:r.shape[0]].to(r.device).float() for p, r in zip(program, like)]
    return out if all(p.shape == r.shape for p, r in zip(out, like)) else None


def pyramid_gaps(program: Optional[Sequence[torch.Tensor]], own: Sequence[torch.Tensor],
                 exact: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """(``pyramid_err_ratio``, ``pyramid_rel``) of one batch: over the
    levels, the largest ratio of the program's and the reference's int8
    distances from the folded float32 level, and the largest relative gap
    between the two int8 levels; (``MISSING``, 1) without the program's."""
    if program is None:
        return MISSING, 1.0
    ratio = max(float((p - e).norm() / (o - e).norm().clamp_min(1e-30)) for p, o, e in zip(program, own, exact))
    rel = max(float((p - o).norm() / o.norm().clamp_min(1e-30)) for p, o in zip(program, own))
    return ratio, rel


def judge(sd: Dict[str, torch.Tensor], cfg: Dict, calibration: np.ndarray, program_scales: Dict[str, float],
          batches: List[Dict]) -> Tuple[Dict[str, float], Dict[str, float], List]:
    """(the numbers compared, the diagnostics, :mod:`.judge_detect`'s
    readings). ``calibration``: the u8 tiles [B, H, W] the program
    calibrated on; ``program_scales`` {site: scale}; ``batches``: per
    judged batch, what :func:`.judge_detect.judge_batch` takes, its
    ``tiles`` and the ``pyramid`` (P2..P6, or None) the program made on them."""
    dev = sd["backbone.conv1.weight"].device
    own = Q.calibrate(sd, cfg, mold(calibration, cfg, dev))
    act_rel, mismatch = scale_gaps(program_scales, own)
    readings = []
    with _int8_layers(Q.Graph(sd, cfg, scales=own), Q.Graph(sd, cfg)) as layers:
        for b in batches:
            layers.program = b.get("pyramid")
            readings.append(judge_detect.judge_batch(sd, cfg, b["tiles"], b))
    if not readings:
        return {}, {}, readings
    compared, diagnostics = judge_detect.merge(readings)
    ratio, rel = (max(g) for g in zip(*layers.gaps))
    compared = {"act_scale_rel": act_rel, "sites_mismatch": mismatch, "pyramid_err_ratio": ratio, **compared}
    return compared, dict(diagnostics, pyramid_rel=rel), readings
