"""Comparison of two detectors' per-image results that allows for near ties.

Random weights make near-tied detection scores common, and two detectors
whose arithmetic differs in the last bits (JAX against PyTorch, or the card
against the CPU) may order such detections differently, or swap which of
two near-tied boxes survives NMS. So only *isolated* detections are
compared: those whose score is more than ``gap`` away from every other
score of the same image. Each isolated detection of the reference is
paired with the detection of the other result whose score is nearest;
a pair further apart than ``gap / 2`` counts as unmatched.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def settle_flax_weights(variables: Dict) -> Dict:
    """Seeded random flax weights, changed so that a detector produces
    detections to compare (in place on a numpy variable tree).

    On raw 0..255 pixels random weights saturate every softmax: all RPN
    scores tie at 1.0 and every ROI is background. Scaling the stem kernel
    by 1/255 puts the input in [0, 1], and a -1 background logit bias lets
    foreground classes win.
    """
    params = variables["params"]
    stem = params["backbone"]["conv1"]
    stem["kernel"] = np.asarray(stem["kernel"]) / 255.0
    logits = params["classifier_head"]["mrcnn_class_logits"]
    bias = np.array(logits["bias"], np.float32)
    bias[0] = -1.0
    logits["bias"] = bias
    return variables


def isolated(scores: np.ndarray, gap: float) -> np.ndarray:
    """Bool mask of scores more than ``gap`` from every other score."""
    s = np.asarray(scores, np.float64)
    if s.size < 2:
        return np.ones(s.shape, bool)
    d = np.abs(s[:, None] - s[None, :])
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1) > gap


def pair_detections(
    ref_scores: np.ndarray, got_scores: np.ndarray, gap: float = 1e-4
) -> List[Tuple[int, int]]:
    """(i, j) for every isolated detection i of ``ref``; j is the detection
    of ``got`` with the nearest score, or -1 if none lies within gap / 2."""
    ref = np.asarray(ref_scores, np.float64)
    got = np.asarray(got_scores, np.float64)
    pairs = []
    for i in np.flatnonzero(isolated(ref, gap)):
        j = int(np.argmin(np.abs(got - ref[i]))) if got.size else -1
        if j >= 0 and abs(got[j] - ref[i]) > gap / 2:
            j = -1
        pairs.append((int(i), j))
    return pairs


def compare_detections(ref: Dict, got: Dict, gap: float = 1e-4) -> Dict:
    """Compare two results of one image over their isolated detections.

    ``ref`` and ``got`` hold ``scores`` and ``class_ids`` and any of
    ``boxes`` ([n, 4], normalized), ``rois`` ([n, 4], pixels) and
    ``masks`` ([H, W, n]). Returns ``compared`` (pairs found),
    ``unmatched`` (isolated reference detections without a partner),
    ``class_mismatch``, ``mask_pixels_differ`` and the largest absolute
    difference of ``scores``, ``boxes`` and ``rois`` over the pairs.
    """
    pairs = pair_detections(ref["scores"], got["scores"], gap)
    found = [(i, j) for i, j in pairs if j >= 0]
    ii = np.array([i for i, _ in found], int)
    jj = np.array([j for _, j in found], int)
    out = {
        "compared": len(found),
        "unmatched": len(pairs) - len(found),
        "class_mismatch": int(
            (np.asarray(ref["class_ids"])[ii] != np.asarray(got["class_ids"])[jj]).sum()
        ),
    }
    for key in ("scores", "boxes", "rois"):
        if key in ref:
            a = np.asarray(ref[key], np.float64)[ii]
            b = np.asarray(got[key], np.float64)[jj]
            out[f"max_{key}_diff"] = float(np.abs(a - b).max()) if len(found) else 0.0
    if "masks" in ref:
        a = np.asarray(ref["masks"])[..., ii]
        b = np.asarray(got["masks"])[..., jj]
        out["mask_pixels_differ"] = int((a != b).sum())
    return out
