"""The port's data parallelism on the host layer and in detect, on the CPU:

* the multi-process tiled ``SFinder``: two Gloo ranks
  (``tests/torch_dist_worker.py``) split the tiles round robin and rank 0
  merges and writes; with the fake tile detector of ``tests/test_sfinder.py``
  and with a small detector with pinned heads (``testing.pin_heads``), the
  catalog JSON and the DS9 file equal the one-process port's byte for byte;
* the ``Detector`` over several devices from one process
  (``local_devices("cpu", 2)`` stand in for two cards): float and int8,
  equal to the one-device port ``Detector`` within 1e-5 (scores, and boxes
  normalized), and to the JAX package's ``Detector(mesh=...)`` within the
  tolerances of ``tests/test_torch_detector.py`` (float) and
  ``tests/test_torch_quant.py`` (int8, both on the JAX detector's
  quantized tree);
* ``build_detector``'s shrink to the cards there are.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.parallel.mesh import make_mesh
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference import detector as TD
from caesar_mrcnn_tpu_torch.parallel.mesh import local_devices
from caesar_mrcnn_tpu_torch.testing import compare_detections, settle_flax_weights
from caesar_mrcnn_tpu_torch.utils import fits as F
from test_torch_dist import run_workers

torch.set_num_threads(2)


# ------------------------------------------------------------------ SFinder


@pytest.mark.parametrize("kind", ["fake", "pinned"])
def test_two_process_catalog_equals_one_process(kind, tmp_path, monkeypatch):
    """A 384^2 mosaic (3 x 3 tiles of 128^2) with blocks inside a tile and
    across the x = 128 and x = 256 boundaries: five tiles on rank 0, four
    on rank 1, the straddling blocks merged on rank 0. The one-process run
    is the worker too, as a group of one (SerialComm), so that both run
    with one thread."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    data = rng.normal(0.0, 0.01, (384, 384)).astype(np.float32)
    data[20:40, 20:40] += 10.0
    data[100:120, 118:140] += 10.0
    data[158:178, 246:266] += 10.0
    F.write_fits(data, str(tmp_path / "mosaic.fits"),
                 header={"CDELT1": -2.8e-4, "CDELT2": 2.8e-4, "BMAJ": 1.5e-3, "BMIN": 1.2e-3})
    run_workers("sfinder", tmp_path, kind, "two")
    run_workers("sfinder", tmp_path, kind, "one", world=1)  # the same thread count, one process
    catalog = json.loads((tmp_path / "one.json").read_text())
    assert len(catalog["objs"]) >= 2 and any(o.get("merged") for o in catalog["objs"])
    assert (tmp_path / "two.json").read_bytes() == (tmp_path / "one.json").read_bytes()
    assert (tmp_path / "two.reg").read_bytes() == (tmp_path / "one.reg").read_bytes()


# ------------------------------------------------------------------ Detector

KW = dict(
    backbone="custom", image_min_dim=128, image_max_dim=128, num_classes=4,
    class_names=("bkg", "sidelobe", "source", "galaxy"), images_per_device=1,
    pre_nms_limit=256, post_nms_rois_inference=64, detection_max_instances=16,
    compute_dtype="float32", score_thr=0.0,
)


@pytest.fixture(scope="module")
def weights():
    """``init_model``'s PRNGKey(0) variables of the detect config, settled
    (``settle_flax_weights``), as a numpy flax tree, and the JAX model."""
    jcfg = jconfig.inference_config(jconfig.detector_config(**KW))
    jmodel = JaxMaskRCNN(jcfg)
    dummy = jnp.zeros((1,) + jcfg.image_shape, jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    return settle_flax_weights(jax.tree_util.tree_map(np.array, variables)), jmodel


def _raw(fetched, i):
    det = fetched[0][i]
    det = det[det[:, 4] > 0]
    return {"boxes": det[:, :4], "class_ids": det[:, 4], "scores": det[:, 5]}


def _assert_close(ref, got, min_compared, tol, gap=1e-4):
    cmp = compare_detections(ref, got, gap)
    assert cmp["compared"] >= min_compared and cmp["unmatched"] == 0 and cmp["class_mismatch"] == 0, cmp
    for key, bound in tol.items():
        assert cmp[f"max_{key}_diff"] <= bound, (key, cmp)
    return cmp


@pytest.mark.parametrize("quant_mode", ["none", "int8"])
def test_detector_over_two_devices(weights, quant_mode):
    """Two replicas, one image each: tiles (dispatch/collect, two batches
    in flight) and host images (detect) against the one-device detector
    on the same global batch and the JAX detector on a 2-device mesh. In
    int8, the calibration runs once, on the global batch."""
    tree, jmodel = weights
    cfg = inference_config(detector_config(**KW, quant_mode=quant_mode), num_devices=2)
    serial_cfg = cfg.replace(images_per_device=2, num_devices=1)
    two = TD.build_detector(cfg, device="cpu", weights=tree)
    one = TD.build_detector(serial_cfg, device="cpu", weights=tree)
    assert two.devices == local_devices("cpu", 2) and len(two._models) == 2 and two.config.batch_size == 2
    jcfg = jconfig.inference_config(jconfig.detector_config(**KW, quant_mode=quant_mode), num_devices=2)
    jdet = JaxDetector(jcfg, jmodel, tree, mesh=make_mesh(n_devices=2))

    rs = np.random.RandomState(3)
    tiles = rs.randint(0, 255, (2, 128, 128), np.uint8)
    h1, h2 = two.dispatch_tiles(tiles), two.dispatch_tiles(255 - tiles[:1])
    got, got2 = two.fetch(h1), two.fetch(h2)
    ref = one.fetch(one.dispatch_tiles(tiles))
    jref = jdet.fetch(jdet.dispatch_tiles(tiles))
    jax_got, jax_tol, gap = got, {"scores": 1e-5, "boxes": 1e-4}, 1e-4
    if quant_mode == "int8":
        assert two.qtree is not None and all(s is not None for s in two._replica_stages)
        for site, q in one.qtree.items():  # one calibration, on the global batch, as the one-device one
            np.testing.assert_array_equal(two.qtree[site]["w"], q["w"])
            assert float(two.qtree[site]["s_in"]) == float(q["s_in"]), site
        # the two packages' f32 calibrations differ in the last bits of a few
        # scales (tests/test_torch_quant.py): against JAX, both run its tree
        on_jax_tree = TD.build_detector(cfg, device="cpu", weights=tree)
        on_jax_tree.use_qtree(jax.tree_util.tree_map(np.asarray, jdet.variables["quant"]))
        jax_got, jax_tol, gap = on_jax_tree.fetch(on_jax_tree.dispatch_tiles(tiles)), {"scores": 1e-4, "boxes": 1e-4}, 2e-3
    for i in range(2):
        _assert_close(_raw(ref, i), _raw(got, i), 2, {"scores": 1e-5, "boxes": 1e-5})
        _assert_close(_raw(jref, i), _raw(jax_got, i), 2, jax_tol, gap=gap)
    _assert_close(_raw(one.fetch(one.dispatch_tiles(255 - tiles[:1])), 0), _raw(got2, 0), 1,
                  {"scores": 1e-5, "boxes": 1e-5})
    assert len(two.unmold_fetched(got)) == 2 and len(two.unmold_fetched(got2)) == 1

    images = [rs.randint(0, 255, (100, 120, 3), np.uint8), rs.randint(0, 255, (128, 96, 3), np.uint8)]
    for g, r in zip(two.detect(images), one.detect(images)):
        assert g["masks"].shape == r["masks"].shape
        assert _assert_close(r, g, 1, {"scores": 1e-5, "rois": 0.0})["mask_pixels_differ"] == 0


def test_replicas_follow_new_weights(weights):
    """A replica takes the first device's weights whenever they change."""
    tree, _ = weights
    det = TD.build_detector(inference_config(detector_config(**KW), num_devices=2), device="cpu", weights=tree)
    with torch.no_grad():
        det.model.backbone.conv1.weight.mul_(0.5)
    det.detect_tiles(np.zeros((2, 128, 128), np.uint8))
    assert torch.equal(det._models[1].backbone.conv1.weight, det.model.backbone.conv1.weight)
    assert det._models[1] is not det.model


def test_build_detector_shrinks_to_the_cards_there_are(weights, monkeypatch, caplog):
    """num_devices=4 on a machine with one card: one device, batch 4 -> 1,
    with the warning (the JAX ``build_detector``'s shrink)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    made = {}

    class Recorder(TD.Detector):
        def __init__(self, config, model, device):
            made["config"], made["device"] = config, device

    monkeypatch.setattr(TD, "Detector", Recorder)
    cfg = inference_config(detector_config(**KW), num_devices=4)
    with caplog.at_level(logging.WARNING):
        TD.build_detector(cfg, device="cuda", weights=weights[0])
    assert made["config"].num_devices == 1 and made["config"].batch_size == 1
    assert made["device"] == torch.device("cuda", 0)
    assert "only 1 local devices: shrinking to num_devices=1 (batch 4 -> 1)" in caplog.text
