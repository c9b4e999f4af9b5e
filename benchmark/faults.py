"""Faults planted under a detect cell's timed path, to show that its
comparison finds them: each is a context manager that patches the port in
this process only, and a detector factory for the driver. The files of the
port are never touched.

* ``moved_box``: an answer altered where it is produced: the refinement
  moves each image's first detection by half the tile (down, or up where
  that would leave the tile), so the detection no longer follows from its
  proposal;
* ``half_batch``: half of the batch left out: the step runs on the first
  half of the tiles twice, and the second half's results are the first
  half's;
* ``rpn_delta``: the RPN's box deltas decoded at twice the configuration's
  ``rpn_bbox_std_dev``, so every proposal lies off its anchor's box;
* ``rpn_score``: each anchor's objectness taken from the anchor before it,
  so the proposals are the boxes of the wrong anchors.
"""

from __future__ import annotations

import contextlib

import torch

from .drivers import detect_tiles


@contextlib.contextmanager
def moved_box():
    from caesar_mrcnn_tpu_torch.models import mask_rcnn

    refine = mask_rcnn.refine_detections

    def moved(*args, **kwargs):
        det = refine(*args, **kwargs).clone()
        y1, y2 = det[:, 0, 0], det[:, 0, 2]
        shift = torch.where(y2 + 0.5 <= 1.0, torch.full_like(y1, 0.5), torch.full_like(y1, -0.5))
        shift = torch.where(det[:, 0, 4] > 0, shift, torch.zeros_like(shift))
        det[:, 0, 0] = (y1 + shift).clamp(0.0, 1.0)
        det[:, 0, 2] = (y2 + shift).clamp(0.0, 1.0)
        return det

    with detect_tiles.patched(mask_rcnn, "refine_detections", moved):
        yield detect_tiles.build_detector


@contextlib.contextmanager
def half_batch():
    def factory(model_cfg, sd, device):
        det = detect_tiles.build_detector(model_cfg, sd, device)
        dispatch = det.dispatch_tiles

        def first_half_twice(tiles):
            half = (len(tiles) + 1) // 2
            return dispatch(tiles[:half].repeat(2, axis=0)[:len(tiles)])

        det.dispatch_tiles = first_half_twice
        return det

    yield factory


@contextlib.contextmanager
def _proposals(change):
    """Proposals made from what ``change(probs, deltas, std)`` returns."""
    from caesar_mrcnn_tpu_torch.models import mask_rcnn

    generate = mask_rcnn.generate_proposals

    def wrong(rpn_probs, rpn_bbox, anchors, rpn_bbox_std_dev, **kwargs):
        probs, deltas, std = change(rpn_probs, rpn_bbox, rpn_bbox_std_dev)
        return generate(probs, deltas, anchors, std, **kwargs)

    with detect_tiles.patched(mask_rcnn, "generate_proposals", wrong):
        yield detect_tiles.build_detector


def rpn_delta():
    return _proposals(lambda probs, deltas, std: (probs, deltas, std * 2.0))


def rpn_score():
    return _proposals(lambda probs, deltas, std: (torch.roll(probs, 1, dims=1), deltas, std))


FAULTS = {"moved_box": moved_box, "half_batch": half_batch, "rpn_delta": rpn_delta, "rpn_score": rpn_score}
