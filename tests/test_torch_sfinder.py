"""The port's host layer as a whole against the JAX package's, on the CPU:
``SFinder.run`` and ``run_tiled`` with the fake detectors of
``tests/test_sfinder.py``, ``ModelTester`` with the fake detector and the
dataset of ``tests/test_tester.py``, and both again through the real
detectors: the port's ``Detector`` (``device="cpu"``, the kernels' plain
versions) against the JAX package's, with the same weights.

Comparison: catalogs as written to their JSON files, through
``caesar_mrcnn_tpu_torch.testing.catalog_differences`` (every value equal,
but the source parameters within 1e-9 relative and, through the real
detectors, scores within 1e-5: JAX's and PyTorch's softmax of the same
logits may differ in the last bit); DS9 files byte for byte; the
tester's CSVs and JSON dumps byte for byte with the fake detector, and
value for value (scores within 1e-5) through the real detectors.
"""

import csv
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.analysis.sfinder import SFinder as JSFinder
from caesar_mrcnn_tpu.analysis.tester import ModelTester as JModelTester
from caesar_mrcnn_tpu.data.dataset import SourceDataset as JSourceDataset
from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.analysis.sfinder import SFinder as TSFinder
from caesar_mrcnn_tpu_torch.analysis.tester import ModelTester as TModelTester
from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset as TSourceDataset
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.parallel import dist
from caesar_mrcnn_tpu_torch.testing import catalog_differences, pin_heads
from caesar_mrcnn_tpu_torch.utils import fits as F
from test_sfinder import FakeDetector, FakeTileDetector
from test_tester import FakeDetector as FakeTesterDetector

torch.set_num_threads(2)

CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")


def _configs(**kw):
    """The same configuration for the port and, field by field, for the JAX
    package: test_sfinder.py's tiling at 128^2."""
    base = dict(num_classes=4, class_names=CLASS_NAMES, score_thr=0.5, images_per_device=2, num_devices=1,
                tile_xsize=128, tile_ysize=128, tile_xstep=1.0, tile_ystep=1.0)
    base.update(kw)
    return tconfig.detector_config(**base), jconfig.detector_config(**base)


@pytest.fixture()
def mosaic(tmp_path):
    """test_sfinder.py's mosaic: 256^2, blob A inside tile (0, 0), blob B
    straddling x = 128."""
    rng = np.random.RandomState(0)
    data = rng.normal(0.0, 0.01, (256, 256)).astype(np.float32)
    data[40:60, 40:60] += 10.0
    data[100:120, 120:140] += 10.0
    path = str(tmp_path / "mosaic.fits")
    F.write_fits(data, path, header={"CRPIX1": 128.0, "CRPIX2": 128.0, "CRVAL1": 150.0, "CRVAL2": 2.0,
                                     "CDELT1": -2.8e-4, "CDELT2": 2.8e-4, "BMAJ": 1.5e-3, "BMIN": 1.2e-3})
    return path


def _catalogs(tmp_path, path, finders, method="run_tiled", **kwargs):
    """Run each (name, SFinder) on ``path``; their written catalogs and DS9
    files, by name."""
    out = {}
    for name, sf in finders:
        sf.outfile_json = str(tmp_path / f"{name}.json")
        sf.outfile_ds9 = str(tmp_path / f"{name}.reg")
        getattr(sf, method)(path, **kwargs)
        out[name] = (json.loads(Path(sf.outfile_json).read_text()), Path(sf.outfile_ds9).read_bytes())
    return out


def _assert_same_catalogs(out, score_atol=0.0, min_sources=1):
    (ref, ref_reg), (got, got_reg) = out["jax"], out["torch"]
    assert len(ref["objs"]) >= min_sources
    assert catalog_differences(ref, got, rtol=1e-9, score_atol=score_atol) == []
    assert got_reg == ref_reg
    # one polygon per border of 3 points or more (sources of 1 or 2 pixels have none)
    assert got_reg.count(b"polygon(") == sum(len(o["vertexes"]) for o in got["objs"])


TILED_CASES = {
    "u8 wire": (dict(tile_wire="u8", image_min_dim=128, image_max_dim=128), "tile"),
    "detect path": (dict(), "plain"),
    "overlapping grid": (dict(tile_xstep=0.5, tile_ystep=0.5), "plain"),
    "pipeline depth 0": (dict(tile_pipeline_depth=0, image_min_dim=128, image_max_dim=128), "tile"),
    "rectangular tiles": (dict(tile_xsize=128, tile_ysize=96, image_min_dim=96, image_max_dim=128,
                               input_shape_override=(96, 128)), "tile"),
}


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_sfinder_tiled_equals_jax(case, mosaic, tmp_path, monkeypatch):
    """run_tiled: the same sources (the straddling blob merged across
    tiles), pixels, contours, edge flags and source parameters, and the
    same DS9 file, through the tile wire and through ``detect``."""
    monkeypatch.chdir(tmp_path)
    kw, kind = TILED_CASES[case]
    tcfg, jcfg = _configs(split_img_in_tiles=True, **kw)
    dets = ((FakeTileDetector(tcfg), FakeTileDetector(jcfg)) if kind == "tile"
            else (FakeDetector(tcfg.batch_size), FakeDetector(jcfg.batch_size)))
    out = _catalogs(tmp_path, mosaic, [("torch", TSFinder(dets[0], tcfg)), ("jax", JSFinder(dets[1], jcfg))])
    _assert_same_catalogs(out, min_sources=2)
    assert sum(bool(o.get("merged")) for o in out["torch"][0]["objs"]) == 1
    if kind == "tile":
        assert dets[0].wire_calls["u8"] > 0 and dets[0].wire_calls["slow"] == 0


@pytest.mark.parametrize("window", [None, (64, 200, 30, 180)])
def test_sfinder_serial_equals_jax(window, mosaic, tmp_path, monkeypatch):
    """run on the whole image and on a sub-window (catalog in the full
    image's frame): sources, WCS parameters and DS9 file equal."""
    monkeypatch.chdir(tmp_path)
    tcfg, jcfg = _configs()
    kwargs = dict(zip(("xmin", "xmax", "ymin", "ymax"), window)) if window else {}
    out = _catalogs(tmp_path, mosaic, [("torch", TSFinder(FakeDetector(), tcfg)),
                                       ("jax", JSFinder(FakeDetector(), jcfg))], method="run", **kwargs)
    _assert_same_catalogs(out, min_sources=1 if window else 2)
    assert all("x0_wcs" in o["pars"] for o in out["torch"][0]["objs"])


def test_sfinder_refuses_what_the_port_does_not_take(mosaic, tmp_path, monkeypatch):
    """The raw wire is on the ROADMAP's "Not to port" list and the overlay
    waits for A16: each raises; so does a launcher's ``WORLD_SIZE`` above 1
    without an initialized process group, so that no rank writes a
    catalog of its own tiles alone."""
    monkeypatch.chdir(tmp_path)
    tcfg, _ = _configs(split_img_in_tiles=True, tile_wire="raw", image_min_dim=128, image_max_dim=128)
    with pytest.raises(ValueError, match="Not to port"):
        TSFinder(FakeTileDetector(tcfg), tcfg).run_tiled(mosaic)
    sf = TSFinder(FakeDetector(), _configs()[0])
    sf.outfile_img = str(tmp_path / "overlay.png")
    with pytest.raises(NotImplementedError, match="A16"):
        sf.run(mosaic)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no torch.distributed group is initialized"):
        TSFinder(FakeDetector(), _configs(split_img_in_tiles=True)[0])
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert isinstance(dist.get_comm(), dist.SerialComm)


# ------------------------------------------------------------- ModelTester


def _write_dataset(root: Path) -> str:
    """test_tester.py's dataset: three 96^2 images with one 16^2 object
    each, two labeled source and one galaxy; returns its list file."""
    rng = np.random.RandomState(0)
    rows = []
    for i in range(3):
        img = rng.normal(0, 0.005, (96, 96)).astype(np.float32)
        y, x = 20 + 10 * i, 25 + 8 * i
        img[y:y + 16, x:x + 16] += 8.0
        mask = np.zeros((96, 96), np.float32)
        mask[y:y + 16, x:x + 16] = 1.0
        F.write_fits(img, str(root / f"img{i}.fits"))
        F.write_fits(mask, str(root / f"mask{i}.fits"))
        rows.append(f"{root}/img{i}.fits,{root}/mask{i}.fits,{('source', 'source', 'galaxy')[i]}")
    (root / "list.dat").write_text("\n".join(rows))
    return str(root / "list.dat")


def _dataset(cls, listfile):
    ds = cls()
    ds.set_class_dict({"sidelobe": 1, "source": 2, "galaxy": 3})
    assert ds.load_data_from_list(listfile) == 0
    ds.prepare()
    return ds


TESTER_FILES = ("completeness.csv", "reliability.csv", "map_summary.json", "metric_computation_input.json",
                "ground_truth_boxes.json", "predicted_boxes.json")


def _run_testers(tmp_path, dets, tcfg, jcfg):
    """One ModelTester.test per package on test_tester.py's dataset; their
    output directories by name."""
    listfile = _write_dataset(tmp_path)
    outdirs = {}
    for name, cls, ds_cls, det, cfg in (("torch", TModelTester, TSourceDataset, dets[0], tcfg),
                                        ("jax", JModelTester, JSourceDataset, dets[1], jcfg)):
        tester = cls(det, cfg, _dataset(ds_cls, listfile))
        tester.outdir = str(tmp_path / name)
        os.makedirs(tester.outdir)
        assert tester.test() == 0
        outdirs[name] = Path(tester.outdir)
    return outdirs


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_model_tester_equals_jax(tmp_path, monkeypatch):
    """The completeness and reliability tables, the mAP summary and the
    three evaluators' dumps, byte for byte."""
    monkeypatch.chdir(tmp_path)
    kw = dict(score_thr=0.5, iou_thr=0.6, image_min_dim=96, image_max_dim=96)
    tcfg, jcfg = _configs(**kw)
    out = _run_testers(tmp_path, (FakeTesterDetector(), FakeTesterDetector()), tcfg, jcfg)
    got, ref = _tree(out["torch"]), _tree(out["jax"])
    assert set(TESTER_FILES) <= set(ref) and any(k.startswith("detections/") for k in ref)
    assert got == ref
    summary = json.loads(got["map_summary.json"])
    assert summary["voc"]["source"] == pytest.approx(1.0, abs=1e-6)


class RaisingDetector:
    def detect(self, images):
        raise RuntimeError("kernel launch failed")


def test_model_tester_detector_errors_propagate(tmp_path):
    """A detector that fails does not leave images uncounted: the test
    raises (the JAX package logs and goes on)."""
    tcfg, _ = _configs(image_min_dim=96, image_max_dim=96)
    tester = TModelTester(RaisingDetector(), tcfg, _dataset(TSourceDataset, _write_dataset(tmp_path)))
    tester.outdir = str(tmp_path)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tester.test()


# ------------------------------------------------------- real detectors

# tests/test_detect_e2e.py's configuration, tiled at 128^2
DETECT_KW = dict(backbone="custom", image_min_dim=128, image_max_dim=128, num_classes=4, class_names=CLASS_NAMES,
                 images_per_device=1, pre_nms_limit=256, post_nms_rois_inference=64, detection_max_instances=16,
                 compute_dtype="float32", tile_xsize=128, tile_ysize=128, tile_xstep=1.0, tile_ystep=1.0)


@pytest.fixture(scope="module")
def detectors():
    """(JAX Detector, port Detector on the CPU) with the same weights:
    ``PRNGKey(0)``'s variables, heads pinned (``testing.pin_heads``) and
    carried to the JAX tree by ``weights.state_dict_to_flax``."""
    tcfg = tconfig.inference_config(tconfig.detector_config(**DETECT_KW))
    jcfg = jconfig.inference_config(jconfig.detector_config(**DETECT_KW))
    jmodel = JaxMaskRCNN(jcfg)
    dummy = jnp.zeros((1,) + jcfg.image_shape, jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    tdet = build_detector(tcfg, device="cpu", weights=jax.tree_util.tree_map(np.array, variables))
    pin_heads(tdet.model)
    return JaxDetector(jcfg, jmodel, W.state_dict_to_flax(tdet.model.state_dict())), tdet


def test_sfinder_through_the_detectors_equals_jax(detectors, tmp_path, monkeypatch):
    """run_tiled over a 3 x 3-tile mosaic (two bright blocks, one
    straddling the x = 256 tile boundary) through each package's Detector:
    the same catalog (sources merged across tiles included) and DS9 file."""
    monkeypatch.chdir(tmp_path)
    jdet, tdet = detectors
    rng = np.random.RandomState(0)
    data = rng.normal(0.0, 0.01, (384, 384)).astype(np.float32)
    data[20:40, 20:40] += 10.0
    data[158:178, 246:266] += 10.0
    path = str(tmp_path / "mosaic.fits")
    F.write_fits(data, path, header={"CDELT1": -2.8e-4, "CDELT2": 2.8e-4, "BMAJ": 1.5e-3, "BMIN": 1.2e-3})
    out = _catalogs(tmp_path, path, [("torch", TSFinder(tdet, tdet.config)), ("jax", JSFinder(jdet, jdet.config))])
    _assert_same_catalogs(out, score_atol=1e-5, min_sources=3)
    assert any(o.get("merged") for o in out["torch"][0]["objs"])


def _rows(path: Path):
    with open(path) as f:
        f.read(2)  # the "# " before the header
        return list(csv.DictReader(f))


def test_model_tester_through_the_detectors_equals_jax(detectors, tmp_path, monkeypatch):
    """ModelTester.test through each package's Detector: the same tables
    and dumps, every value equal but the scores (within 1e-5)."""
    monkeypatch.chdir(tmp_path)
    jdet, tdet = detectors
    out = _run_testers(tmp_path, (tdet, jdet), tdet.config, jdet.config)
    for name in ("completeness.csv", "reliability.csv"):
        got, ref = _rows(out["torch"] / name), _rows(out["jax"] / name)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            for k in r:
                if k == "score":
                    assert float(g[k]) == pytest.approx(float(r[k]), abs=1e-5)
                else:
                    assert g[k] == r[k], (name, k)
    for name in ("map_summary.json", "metric_computation_input.json", "predicted_boxes.json"):
        got, ref = json.loads((out["torch"] / name).read_text()), json.loads((out["jax"] / name).read_text())
        np.testing.assert_allclose(_floats(got), _floats(ref), rtol=0, atol=1e-5, err_msg=name)
        assert _shape(got) == _shape(ref), name


def _floats(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _floats(tree[k])]
    if isinstance(tree, list):
        return [v for x in tree for v in _floats(x)]
    return [float(tree)]


def _shape(tree):
    if isinstance(tree, dict):
        return {k: _shape(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape(x) for x in tree]
    return type(tree).__name__
