"""The masks' paste into the tiles' frames (``ops/paste.py``, the operator
``caesar::paste_masks``) and the tiled detect path through it, on the CPU.

The kernel runs only on a card (``tests/test_torch_kernels_cuda.py``
holds it to the plain version there). Here:

* the plain version against the host unmold (``Detector.unmold_detections``
  on a full-frame window, one ``utils/image.py::paste_mask`` a detection),
  bit for bit: zero-area boxes, no detection, every slot a detection, boxes
  on the tile's edges and across the whole tile;
* the tiled path, which pastes through the operator on every device (the
  plain version here): ``fetch``'s first five fields as without the paste,
  every field of ``unmold_fetched``'s results (value, dtype, shape) as the
  host unmold gives them from the same fetched batch, and ``detect``
  never pasting; a kept result's frame untouched by later batches; a
  frame held until its batch's events complete; the counters;
* the wrapper's refusals.
"""

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch import telemetry
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.ops import paste as P

torch.set_num_threads(2)

KW = dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
          class_names=("bkg", "sidelobe", "source", "galaxy"), rpn_anchor_scales=(8, 16, 32, 64, 128),
          pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=8, compute_dtype="float32")
FIELDS = ("rois", "class_ids", "scores", "masks")


@pytest.fixture(scope="module")
def det():
    return build_detector(inference_config(detector_config(**KW), images_per_device=2, num_devices=1),
                          device="cpu", seed=0)


def _tiles(seed, n=2):
    return np.random.RandomState(seed).randint(0, 255, (n, 64, 64), np.uint8)


def _detections(case, rng, shape, d=12):
    """[d, 6] padded detections of one tile of ``shape`` and its u8 masks
    [d, 28, 28]. A box is dropped where its pixel height or width is 0 or
    less (y2 or x2 below y1 or x1 by a pixel or more)."""
    y1, x1 = rng.uniform(0, 1, (2, d))
    side = np.where(rng.uniform(0, 1, (2, d)) < 0.3, rng.uniform(0.5, 1.0, (2, d)), rng.uniform(0, 0.2, (2, d)))
    boxes = np.stack([y1, x1, y1 + side[0], x1 + side[1]], -1).clip(0, 1)
    cls = rng.randint(1, 4, d).astype(np.float64)
    if case == "zero-area boxes":
        boxes[::3, 2] = boxes[::3, 0] - 0.05
        boxes[1::3, 3] = boxes[1::3, 1] - 1.0 / (shape[1] - 1)  # x2 + 1 rounds onto x1
    elif case == "no detection":
        cls[:] = 0
    elif case == "edge boxes":
        boxes[::4, 0] = boxes[1::4, 1] = 0.0
        boxes[2::4, 2] = boxes[3::4, 3] = 1.0
        boxes[5] = (0.0, 0.0, 1.0, 1.0)
    elif case == "mixed":
        cls[9:] = 0  # padding after nine detections
        cls[11] = 2  # a class id after the first zero is padding too
    det = np.concatenate([boxes, cls[:, None], rng.uniform(0, 1, (d, 1))], -1).astype(np.float32)
    return det, rng.randint(0, 256, (d, 28, 28)).astype(np.uint8)


@pytest.mark.parametrize("case", ["mixed", "zero-area boxes", "no detection", "every slot", "edge boxes"])
@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_plain_paste_equals_the_host_unmold(det, case, shape):
    rng = np.random.RandomState(len(case) + shape[1])
    tiles = [_detections(case, rng, shape) for _ in range(3)]
    dets = torch.from_numpy(np.stack([t[0] for t in tiles]))
    masks = torch.from_numpy(np.stack([t[1] for t in tiles]))
    frames = [torch.ones(shape[0] * shape[1] * 12, dtype=torch.bool) for _ in tiles]
    P.paste_masks(dets, masks, frames, shape)
    h, w = shape
    for (d, m), frame in zip(tiles, frames):
        rois, class_ids, scores, full = det.unmold_detections(d, m, shape, shape, (0, 0, h, w))
        rows, boxes = P.kept_boxes(d, shape)
        np.testing.assert_array_equal(boxes, rois)
        np.testing.assert_array_equal(d[rows, 4].astype(np.int32), class_ids)
        np.testing.assert_array_equal(d[rows, 5], scores)
        np.testing.assert_array_equal(frame[: full.size].view(full.shape).numpy(), full)
        assert frame[full.size:].all()  # past the [H, W, n] prefix, nothing is written
        if case == "zero-area boxes":
            assert 0 < full.shape[2] <= 12 - 8
        if case == "no detection":
            assert full.shape == (h, w, 0)
        if case == "every slot":
            assert full.shape == (h, w, 12)


@pytest.mark.parametrize("n_in", [2, 1])
def test_unmold_fetched_unchanged_with_device_paste(det, n_in):
    """Every field, dtype and shape as the host unmold gives them from the
    same fetched batch (``frames`` None); the masks a C-contiguous
    [H, W, n] bool view of the tile's frame."""
    got_fetched = det.fetch(det.dispatch_tiles(_tiles(1, n_in)))
    got = det.unmold_fetched(got_fetched)
    ref = det.unmold_fetched(got_fetched[:5] + (None,))
    assert len(got_fetched[5]) == n_in
    assert sum(len(r["scores"]) for r in got) > 0 and len(got) == len(ref) == n_in
    for r, g, frame in zip(ref, got, got_fetched[5]):
        for key in FIELDS:
            assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape, key
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
        assert g["masks"].flags["C_CONTIGUOUS"] and np.shares_memory(g["masks"], frame.numpy())


def test_fetch_first_five_fields_unchanged(det, monkeypatch):
    """As without the paste (the operator a no-op: frames left unwritten)."""
    got = det.fetch(det.dispatch_tiles(_tiles(2)))
    monkeypatch.setattr(P, "paste_masks", lambda *args: None)
    ref = det.fetch(det.dispatch_tiles(_tiles(2)))
    assert len(ref) == len(got) == 6 and len(ref[5]) == len(got[5]) == 2
    for a, b in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(a, b)
    assert ref[2:4] == got[2:4] and ref[4] != got[4]  # n_in, shape; each batch its own id


def test_detect_unchanged_with_device_paste(det, monkeypatch):
    """``detect`` keeps the host unmold (real windows and scales): it never
    calls the paste, and gives what it gave before the paste was there."""
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 255, (50, 60, 3), np.uint8), rng.randint(0, 255, (64, 40, 3), np.uint8)]
    ref = det.detect(images)
    calls = []
    monkeypatch.setattr(P, "paste_masks", lambda *args: calls.append(args))
    got = det.detect(images)
    assert not calls
    for image, g in zip(images, got):
        assert g["masks"].shape == image.shape[:2] + (len(g["scores"]),)
    for r, g in zip(ref, got):
        for key in FIELDS:
            assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape, key
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)


def test_kept_result_not_overwritten_by_later_batches(det):
    kept = det.collect(det.dispatch_tiles(_tiles(5)))
    want = [r["masks"].copy() for r in kept]
    assert sum(m.sum() for m in want) > 0
    later = [det.collect(det.dispatch_tiles(_tiles(6 + i))) for i in range(5)]
    for r, m in zip(kept, want):
        np.testing.assert_array_equal(r["masks"], m)
    for res in later:
        for r in res:
            assert not any(np.shares_memory(r["masks"], k["masks"]) for k in kept)


class _Event:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_frames_held_until_their_events_complete(det):
    """A batch's frames stay referenced by the detector, whatever becomes
    of its handle, until its events have completed; batches in order."""
    first, second = (_Event(),), (_Event(),)
    frames = [[torch.zeros(4, dtype=torch.bool)], [torch.zeros(4, dtype=torch.bool)]]
    det._pasting.extend([(first, frames[0]), (second, frames[1])])
    try:
        second[0].done = True
        det._release_pasted()
        assert [f for _, f in det._pasting] == frames  # the first one still runs
        first[0].done = True
        det._release_pasted()
        assert not det._pasting
    finally:
        det._pasting.clear()


def test_counters_under_recording(det, monkeypatch):
    """``detect.unmold.device_pasted`` counts the detections pasted, and
    ``launches.paste_masks`` the launches (on the CPU the plain version,
    counted here as the card counts its kernel)."""
    plain = P.paste_masks_plain

    def counted(*args):
        P.paste_masks.launches += 1
        return plain(*args)

    monkeypatch.setattr(P, "paste_masks_plain", counted)
    with telemetry.recording() as rec:
        results = [r for seed in (7, 8) for r in det.collect(det.dispatch_tiles(_tiles(seed)))]
    counters = rec.summary()["counters"]
    assert counters["detect.unmold.device_pasted"] == sum(len(r["scores"]) for r in results) > 0
    assert counters["launches.paste_masks"] == 2
    assert "detect.unmold.resize_ns" not in counters and "detect.unmold.write_ns" not in counters


def test_paste_masks_rejects_what_it_does_not_take():
    dets, masks = torch.zeros(2, 3, 6), torch.zeros(2, 3, 28, 28, dtype=torch.uint8)
    frames = [torch.zeros(16 * 16 * 3, dtype=torch.bool) for _ in range(2)]
    with pytest.raises(ValueError, match="masks"):
        P.paste_masks(dets, masks[:1], frames, (16, 16))
    with pytest.raises(TypeError, match="uint8"):
        P.paste_masks(dets, masks.float(), frames, (16, 16))
    with pytest.raises(ValueError, match="frames for 2 tiles"):
        P.paste_masks(dets, masks, frames[:1], (16, 16))
    with pytest.raises(ValueError, match="816 elements"):
        P.paste_masks(dets, masks, frames, (16, 17))
    with pytest.raises(ValueError, match="aligned"):
        P.paste_masks(dets, masks, [frames[0], torch.zeros(16 * 16 * 3 + 1, dtype=torch.bool)[1:]], (16, 16))
    with pytest.raises(ValueError, match="device"):
        P.paste_masks(dets, masks, frames[:1] + [torch.zeros(768, dtype=torch.bool, device="meta")], (16, 16))
