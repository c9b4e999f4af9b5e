"""The whole detect slice of the port against the JAX Detector, on the
fixture of tests/test_detect_e2e.py (custom backbone, 128^2, 4 classes,
f32, pre-NMS 256, post-NMS 64, 16 detections, ``PRNGKey(0)`` weights),
with the weights converted by ``caesar_mrcnn_tpu_torch.weights``.

Comparison rule: random weights make near-tied scores common, so only
detections whose score is more than 1e-4 from every other score of the
image are compared (``caesar_mrcnn_tpu_torch.testing``). For those: boxes
to atol 1e-4 (normalized), scores to atol 1e-5, class ids and unmolded
pixel boxes equal, masks equal after unmold except at pixels whose bilinear
value lies within float rounding of the 0.5 threshold: there cv2 (the JAX
package) and torch (the port) round the same sum to different sides. Such
pixels are about 1e-4 of all (tests/test_torch_model.py applies the rule
pixel by pixel); here at most 1 in 10^4 compared mask pixels may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align
from caesar_mrcnn_tpu_torch.testing import compare_detections, settle_flax_weights

torch.set_num_threads(2)

KW = dict(
    backbone="custom", image_min_dim=128, image_max_dim=128, num_classes=4,
    class_names=("bkg", "sidelobe", "source", "galaxy"), images_per_device=1,
    pre_nms_limit=256, post_nms_rois_inference=64, detection_max_instances=16,
    compute_dtype="float32", score_thr=0.0,
)
# the same configuration for the port and, field by field, for the JAX package
CFG = inference_config(detector_config(**KW))
JCFG = jconfig.inference_config(jconfig.detector_config(**KW))


@pytest.fixture(scope="module")
def detectors():
    """(JAX Detector, port Detector) with the same weights: ``init_model``'s
    PRNGKey(0) variables, settled by ``settle_flax_weights``."""
    jmodel = JaxMaskRCNN(JCFG)
    dummy = jnp.zeros((1,) + JCFG.image_shape, jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    tree = settle_flax_weights(jax.tree_util.tree_map(np.array, variables))
    return JaxDetector(JCFG, jmodel, tree), build_detector(CFG, device="cpu", weights=tree)


def _raw(fetched):
    """Non-padding rows of one image's [D, 6] detections."""
    det = fetched[0][0]
    det = det[det[:, 4] > 0]
    return {"boxes": det[:, :4], "class_ids": det[:, 4], "scores": det[:, 5]}


def _assert_same(ref, got, min_compared):
    cmp = compare_detections(ref, got)
    assert cmp["compared"] >= min_compared, cmp
    assert cmp["unmatched"] == 0 and cmp["class_mismatch"] == 0, cmp
    assert cmp["max_scores_diff"] <= 1e-5, cmp
    for key, tol in (("boxes", 1e-4), ("rois", 0)):
        if key in ref:
            assert cmp[f"max_{key}_diff"] <= tol, cmp
    if "masks" in ref:
        assert ref["masks"].shape[:2] == got["masks"].shape[:2]
        pixels = cmp["compared"] * ref["masks"].shape[0] * ref["masks"].shape[1]
        assert cmp["mask_pixels_differ"] <= 1e-4 * pixels, cmp
    return cmp


def test_detect_tiles_matches_jax(detectors):
    jdet, tdet = detectors
    tile = np.random.RandomState(3).randint(0, 255, (1, 128, 128), np.uint8)
    nms_padded.launches = roi_align.launches = 0
    fetched = tdet.fetch(tdet.dispatch_tiles(tile))
    assert nms_padded.launches == roi_align.launches == 0  # plain versions on the CPU
    ref_fetched = jdet.fetch(jdet.dispatch_tiles(tile))
    _assert_same(_raw(ref_fetched), _raw(fetched), min_compared=8)
    got = tdet.unmold_fetched(fetched)[0]
    ref = jdet.unmold_fetched(ref_fetched)[0]
    assert got["masks"].shape == (128, 128, len(got["scores"]))
    _assert_same(ref, got, min_compared=8)

    # two batches in flight, then collected in order
    h1 = tdet.dispatch_tiles(tile)
    h2 = tdet.dispatch_tiles(255 - tile)
    r1, r2 = tdet.collect(h1)[0], tdet.collect(h2)[0]
    np.testing.assert_array_equal(r1["rois"], got["rois"])
    _assert_same(jdet.detect_tiles(255 - tile)[0], r2, min_compared=1)


def test_detect_matches_jax(detectors):
    """Host mold (resize to 128^2 square, window) and unmold to the
    original 100 x 120 frame."""
    jdet, tdet = detectors
    image = np.random.RandomState(4).randint(0, 255, (100, 120, 3), np.uint8)
    got = tdet.detect([image])[0]
    ref = jdet.detect([image])[0]
    assert got["masks"].shape == (100, 120, len(got["scores"]))
    _assert_same(ref, got, min_compared=8)
