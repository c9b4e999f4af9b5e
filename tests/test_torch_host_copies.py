"""The port's copies of the JAX package's host modules against their
originals, on the CPU, on seeded inputs: the configuration and its presets,
the anchors, FITS writing and reading, zscale, tiling, the augmentations,
the debug ROIs, the dataset, the native host library, the host layer's
pieces (the graph and statistics helpers, the evaluation metrics, the DS9
regions and the ground-truth matching), the legacy trainer CLI's
translation onto the main CLI, and the synthetic sky.

Every comparison is exact: the copies run the same numpy code, and the two
native libraries are built from the same C++ with the same flags. The one
exception is the synthetic sky's image: its noise is blurred by numpy in
the port and by OpenCV in the JAX package, and the two agree within 4
float32 ulps of the image's largest value (the objects' masks, classes
and SNRs exactly). The JAX
package's library is built into a temporary directory by its own loader,
so that these tests never race the JAX package's tests for its in-tree
``libfastops.so``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu import native as jnative
from caesar_mrcnn_tpu.analysis import gt_eval as jgt_eval
from caesar_mrcnn_tpu.analysis import regions as jregions
from caesar_mrcnn_tpu.cli import train_all as jtrain_all
from caesar_mrcnn_tpu.data import augment as jaugment
from caesar_mrcnn_tpu.data import dataset as jdataset
from caesar_mrcnn_tpu.data import synthetic as jsynthetic
from caesar_mrcnn_tpu.evalmetrics import ap as jap
from caesar_mrcnn_tpu.evalmetrics import coco as jcoco
from caesar_mrcnn_tpu.evalmetrics import voc as jvoc
from caesar_mrcnn_tpu.models import debug_rois as jdebug
from caesar_mrcnn_tpu.utils import anchors as janchors
from caesar_mrcnn_tpu.utils import boxes as jboxes
from caesar_mrcnn_tpu.utils import fits as jfits
from caesar_mrcnn_tpu.utils import graph as jgraph
from caesar_mrcnn_tpu.utils import stats as jstats
from caesar_mrcnn_tpu.utils import tiles as jtiles
from caesar_mrcnn_tpu.utils import zscale as jzscale
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch import native as tnative
from caesar_mrcnn_tpu_torch.analysis import gt_eval as tgt_eval
from caesar_mrcnn_tpu_torch.analysis import masks as tmasks
from caesar_mrcnn_tpu_torch.analysis import regions as tregions
from caesar_mrcnn_tpu_torch.cli import train_all as ttrain_all
from caesar_mrcnn_tpu_torch.data import augment as taugment
from caesar_mrcnn_tpu_torch.data import dataset as tdataset
from caesar_mrcnn_tpu_torch.data import synthetic as tsynthetic
from caesar_mrcnn_tpu_torch.evalmetrics import ap as tap
from caesar_mrcnn_tpu_torch.evalmetrics import coco as tcoco
from caesar_mrcnn_tpu_torch.evalmetrics import voc as tvoc
from caesar_mrcnn_tpu_torch.models import debug_rois as tdebug
from caesar_mrcnn_tpu_torch.utils import anchors as tanchors
from caesar_mrcnn_tpu_torch.utils import boxes as tboxes
from caesar_mrcnn_tpu_torch.utils import fits as tfits
from caesar_mrcnn_tpu_torch.utils import graph as tgraph
from caesar_mrcnn_tpu_torch.utils import stats as tstats
from caesar_mrcnn_tpu_torch.utils import tiles as ttiles
from caesar_mrcnn_tpu_torch.utils import zscale as tzscale
from caesar_mrcnn_tpu_torch.utils.boxes import compute_overlaps

REPO = Path(__file__).resolve().parents[1]
CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")

# The presets the port's tests and chip_smoke.py build.
PRESETS = {
    "default": {},
    "serving flagship": dict(num_classes=4, class_names=CLASS_NAMES, image_min_dim=512, image_max_dim=512,
                             images_per_device=8, compute_dtype="bfloat16"),
    "serving parity": dict(num_classes=4, class_names=CLASS_NAMES, image_min_dim=512, image_max_dim=512,
                           images_per_device=1, compute_dtype="float32"),
    "training flagship": dict(num_classes=4, class_names=CLASS_NAMES, image_min_dim=256, image_max_dim=256,
                              images_per_device=8, compute_dtype="bfloat16", optimizer="adam"),
    "training parity": dict(num_classes=4, class_names=CLASS_NAMES, image_min_dim=128, image_max_dim=128,
                            images_per_device=2, compute_dtype="float32", optimizer="sgd", use_rpn_rois=False),
    "tiny train": dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4, class_names=CLASS_NAMES,
                       images_per_device=2, num_devices=1, rpn_anchor_scales=(8, 16, 32, 64, 128),
                       rpn_train_anchors_per_image=64, pre_nms_limit=256, post_nms_rois_training=64,
                       train_rois_per_image=32, max_gt_instances=4, detection_max_instances=8,
                       compute_dtype="float32", use_mini_mask=True, mini_mask_shape=(28, 28), optimizer="sgd",
                       learning_rate=0.002),
    "tiny detect": dict(backbone="custom", image_min_dim=128, image_max_dim=128, num_classes=4,
                        class_names=CLASS_NAMES, images_per_device=1, pre_nms_limit=256,
                        post_nms_rois_inference=64, detection_max_instances=16, compute_dtype="float32",
                        score_thr=0.0),
}


def _same_config(got, ref):
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.to_dict() == ref.to_dict()
    np.testing.assert_array_equal(got.backbone_shapes, ref.backbone_shapes)
    assert (got.num_anchors, got.batch_size, got.image_shape, got.image_meta_size) == (
        ref.num_anchors, ref.batch_size, ref.image_shape, ref.image_meta_size)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_detector_config_equals_jax(preset):
    kw = PRESETS[preset]
    _same_config(tconfig.detector_config(**kw), jconfig.detector_config(**kw))
    _same_config(tconfig.inference_config(tconfig.detector_config(**kw)),
                 jconfig.inference_config(jconfig.detector_config(**kw)))
    _same_config(tconfig.inference_config(tconfig.detector_config(**kw), images_per_device=2),
                 jconfig.inference_config(jconfig.detector_config(**kw), images_per_device=2))
    _same_config(tconfig.Config(**kw), jconfig.Config(**kw))


@pytest.mark.parametrize("preset", ["serving flagship", "training flagship", "tiny train"])
def test_anchors_equal_jax(preset):
    cfg_t, cfg_j = tconfig.detector_config(**PRESETS[preset]), jconfig.detector_config(**PRESETS[preset])
    np.testing.assert_array_equal(tanchors.get_anchors(cfg_t), janchors.get_anchors(cfg_j))
    np.testing.assert_array_equal(tanchors.get_anchors(cfg_t, (96, 160, 3)), janchors.get_anchors(cfg_j, (96, 160, 3)))
    args = ((4, 8, 16, 32, 64), (0.5, 1.0, 2.0), cfg_t.backbone_shapes, cfg_t.backbone_strides, 1)
    np.testing.assert_array_equal(tanchors.generate_pyramid_anchors(*args), janchors.generate_pyramid_anchors(*args))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module, its library built by its own loader
    from a copy of its sources in a temporary directory."""
    src = Path(jnative.__file__).parent
    tmp = tmp_path_factory.mktemp("jax_native")
    for name in ("fastops.cpp", "Makefile"):
        (tmp / name).write_bytes((src / name).read_bytes())
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_HERE", str(tmp))
    mp.setattr(jnative, "_LIB_PATH", str(tmp / "libfastops.so"))
    mp.setattr(jnative, "_lib", None)
    yield jnative
    mp.undo()


def _mosaic(rng, h, w):
    img = rng.normal(0.0, 0.05, (h, w)).astype(np.float32)
    img[rng.randint(0, h, 20), rng.randint(0, w, 20)] += rng.uniform(1, 30, 20).astype(np.float32)
    img[3, 5] = np.nan
    return img


def test_fits_write_read_and_zscale_equal_jax(tmp_path, jax_native):
    """The two writers give the same bytes; the tile reader and zscale, numpy
    and native, give the same values on that file."""
    assert tnative.available() == jax_native.available()
    rng = np.random.RandomState(0)
    img = _mosaic(rng, 300, 260)
    header = {"BMAJ": 1.5e-3, "BMIN": 1.2e-3, "CDELT1": -2.8e-4, "CDELT2": 2.8e-4, "OBJECT": "field"}
    tfits.write_fits(img, str(tmp_path / "t.fits"), header=header)
    jfits.write_fits(img, str(tmp_path / "j.fits"), header=header)
    assert (tmp_path / "t.fits").read_bytes() == (tmp_path / "j.fits").read_bytes()
    path = str(tmp_path / "t.fits")
    assert tfits.read_header(path) == jfits.read_header(path)
    for window in ((-1, -1, -1, -1), (0, 128, 0, 128), (100, 260, 172, 300), (37, 101, 5, 69)):
        got, ref = tfits.read_tile_u8(path, *window), jfits.read_tile_u8(path, *window)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    data = tfits.read_fits_data(path)[0]
    for contrast in (0.25, 0.1):
        assert tzscale.zscale_limits(data, contrast) == jzscale.zscale_limits(data, contrast)
        assert tnative.zscale_limits(data, contrast) == jax_native.zscale_limits(data, contrast)
    lo, hi = tnative.zscale_limits(data)
    np.testing.assert_array_equal(tnative.stretch_to_u8(data, lo, hi), jax_native.stretch_to_u8(data, lo, hi))


@pytest.mark.parametrize("case", ["plain", "no gt", "touching"])
def test_native_anchor_stats_and_iou_equal_jax_and_numpy(case, jax_native):
    """rpn_anchor_stats and iou_matrix: equal to the JAX package's library,
    and within f32 rounding of the f64 numpy IoU, with the same argmax
    wherever the best IoU is not tied within that rounding."""
    assert tnative.available() == jax_native.available()
    rng = np.random.RandomState({"plain": 1, "no gt": 2, "touching": 3}[case])
    anchors = tanchors.get_anchors(tconfig.detector_config(**PRESETS["tiny train"])) * 63.0
    n = {"plain": 7, "no gt": 0, "touching": 5}[case]
    y1, x1 = rng.uniform(0, 50, (2, n))
    gt = np.stack([y1, x1, y1 + rng.uniform(3, 20, n), x1 + rng.uniform(3, 20, n)], 1).astype(np.float32)
    if case == "touching":
        gt[1] = gt[0]  # an exact duplicate: ties in every column
        gt[2] = [0.0, 0.0, 0.0, 0.0]  # zero area
    iou = tnative.iou_matrix(anchors, gt)
    np.testing.assert_array_equal(iou, jax_native.iou_matrix(anchors, gt))
    ref = compute_overlaps(anchors, gt)
    np.testing.assert_allclose(iou, ref, rtol=0, atol=1e-6)
    stats = tnative.rpn_anchor_stats(anchors, gt)
    jstats = jax_native.rpn_anchor_stats(anchors, gt)
    assert (stats is None) == (jstats is None) == (not tnative.available())
    if stats is None:
        return
    for a, b in zip(stats, jstats):
        np.testing.assert_array_equal(a, b)
    amax, aarg, tie = stats
    if n == 0:
        assert not amax.any() and not aarg.any() and not tie.any()
        return
    np.testing.assert_allclose(amax, ref.max(1), rtol=0, atol=1e-6)
    top2 = np.sort(ref, 1)[:, -2:] if n > 1 else np.concatenate([np.zeros((len(ref), 1)), ref], 1)
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    np.testing.assert_array_equal(aarg[clear], ref.argmax(1)[clear])
    assert tie.any()


def test_native_library_builds_once_under_concurrent_first_use(tmp_path):
    """Four processes load the port's native library at once into an empty
    build directory: all load it, and exactly one library is left, with no
    partial file beside it."""
    if not tnative.available():  # no compiler here: the numpy fallback runs
        assert tnative.rpn_anchor_stats(np.zeros((1, 4), np.float32), np.zeros((1, 4), np.float32)) is None
        return
    code = (
        "import sys\nfrom pathlib import Path\nfrom caesar_mrcnn_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\nprint(native.available())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 and o.strip() == "True" for p, (o, _) in zip(procs, outs)), outs
    built = sorted(p.name for p in tmp_path.iterdir() if not p.name.startswith("."))
    assert built == [tnative.library_path().name], built


@pytest.mark.parametrize("window", [(0, 2048, 0, 2048, 512, 512, 1.0, 1.0), (0, 1000, 0, 700, 256, 200, 0.5, 0.75),
                                    (10, 300, 20, 90, 128, 128, 1.0, 1.0)])
def test_generate_tiles_equals_jax(window):
    assert ttiles.generate_tiles(*window) == jtiles.generate_tiles(*window)


def test_augment_and_debug_rois_equal_jax():
    """The same RandomState draws the same augmentations and random ROIs."""
    rng = np.random.RandomState(4)
    for seed in range(12):
        img = rng.rand(32, 40, 3).astype(np.float32)
        mask = rng.rand(32, 40, 2) > 0.5
        got = taugment.augment_image_and_mask(img, mask, np.random.RandomState(seed))
        ref = jaugment.augment_image_and_mask(img, mask, np.random.RandomState(seed))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    gt = np.array([[4, 6, 20, 30], [30, 2, 60, 18]], np.int32)
    np.testing.assert_array_equal(tdebug.generate_random_rois((64, 64), 40, gt, np.random.RandomState(5)),
                                  jdebug.generate_random_rois((64, 64), 40, gt, np.random.RandomState(5)))


def test_source_dataset_equals_jax(tmp_path):
    """A json-descriptor dataset loads to the same images, masks, class ids
    and image info in both."""
    rng = np.random.RandomState(6)
    for i in range(2):
        objs = []
        for j in range(3):
            mask = np.zeros((48, 48), np.float32)
            y, x = rng.randint(0, 36, 2)
            mask[y:y + 10, x:x + 8] = 1.0
            tfits.write_fits(mask, str(tmp_path / f"m{i}{j}.fits"))
            objs.append({"mask": str(tmp_path / f"m{i}{j}.fits"), "class": CLASS_NAMES[1 + j]})
        tfits.write_fits(_mosaic(rng, 48, 48), str(tmp_path / f"img{i}.fits"))
        (tmp_path / f"img{i}.json").write_text(json.dumps({"img": str(tmp_path / f"img{i}.fits"), "objs": objs}))
    sets = []
    for module in (tdataset, jdataset):
        ds = module.SourceDataset()
        ds.set_class_dict({name: k for k, name in enumerate(CLASS_NAMES) if k})
        for i in range(2):
            assert ds.load_data_from_json_file(str(tmp_path / f"img{i}.json")) == 0
        ds.prepare()
        sets.append(ds)
    got, ref = sets
    np.testing.assert_array_equal(got.image_ids, ref.image_ids)
    assert got.class_names == ref.class_names
    for image_id in got.image_ids:
        np.testing.assert_array_equal(got.load_image(image_id), ref.load_image(image_id))
        for a, b in zip(got.load_mask(image_id), ref.load_mask(image_id)):
            np.testing.assert_array_equal(a, b)


def _blob_masks(rng, h, w, n):
    """[h, w, n] bool masks of seeded rectangles, some overlapping or
    touching, some empty."""
    masks = np.zeros((h, w, n), bool)
    for i in range(n):
        if rng.rand() < 0.1:
            continue
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        masks[y:y + rng.randint(2, 14), x:x + rng.randint(2, 14), i] = True
    return masks


def test_graph_and_stats_equal_jax():
    """Union-find components in the same order; sigma-clipped statistics
    exactly equal, NaNs, constant data and empty data included."""
    rng = np.random.RandomState(7)
    for _ in range(50):
        n = rng.randint(1, 40)
        graphs = (tgraph.Graph(n), jgraph.Graph(n))
        for _ in range(rng.randint(0, 2 * n)):
            v, w = rng.randint(0, n, 2)
            for g in graphs:
                g.addEdge(int(v), int(w))
        assert graphs[0].connectedComponents() == graphs[1].connectedComponents()
    for data in (rng.normal(0, 1, 1000), np.r_[rng.normal(0, 1, 500), [40.0, np.nan, np.inf]],
                 np.full(10, 3.0), np.array([np.nan]), np.zeros(0)):
        for sigma, maxiters in ((3.0, 5), (2.0, 1)):
            got, ref = tstats.sigma_clipped_stats(data, sigma, maxiters), jstats.sigma_clipped_stats(data, sigma, maxiters)
            np.testing.assert_array_equal(got, ref)


def test_evalmetrics_equal_jax(tmp_path):
    """Matterport AP (with mask IoU and zero-row trimming), the Pascal-VOC
    table and the COCO sweep give the same values, and the dumps the same
    files."""
    rng = np.random.RandomState(8)
    for _ in range(6):
        gt_masks, pred_masks = _blob_masks(rng, 48, 48, 5), _blob_masks(rng, 48, 48, 7)
        gt_masks[..., 0] = pred_masks[..., 0]  # one exact match
        gt_boxes = np.r_[tboxes.extract_bboxes(gt_masks), np.zeros((2, 4), np.int32)]
        pred_boxes = tboxes.extract_bboxes(pred_masks).astype(np.float64)
        gt_ids, pred_ids = rng.randint(1, 4, 7), rng.randint(1, 4, 7)
        scores = rng.rand(7)
        args = (gt_boxes, gt_ids, gt_masks, pred_boxes, pred_ids, scores, pred_masks)
        for a, b in zip(tap.compute_ap(*args), jap.compute_ap(*args)):
            np.testing.assert_array_equal(a, b)
        assert tap.compute_ap_range(*args) == jap.compute_ap_range(*args)
        got, ref = tap.compute_recall(pred_boxes, gt_boxes, 0.3), jap.compute_recall(pred_boxes, gt_boxes, 0.3)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(tboxes.compute_overlaps_masks(gt_masks, pred_masks),
                                      jboxes.compute_overlaps_masks(gt_masks, pred_masks))
        np.testing.assert_array_equal(tboxes.trim_zeros(gt_boxes), jboxes.trim_zeros(gt_boxes))
    names = ("sidelobe", "source", "galaxy")
    images = {}
    for image in ("a", "b", "c"):
        xy = rng.randint(0, 90, (6, 2))
        images[image] = np.c_[xy, xy + rng.randint(3, 30, (6, 2))].astype(float)
    gt_rows = [(img, names[i % 3], tuple(b[i])) for img, b in images.items() for i in range(4)]
    det_rows = [(img, names[(i + k) % 3], tuple(b[i] + k), float(rng.rand()))
                for img, b in images.items() for i in range(6) for k in (0, 2)]
    results = {}
    for mod, out in ((tvoc, "t"), (jvoc, "j")):
        gts, dets = [mod.BBox(*r) for r in gt_rows], [mod.BBox(*r) for r in det_rows]
        results[out] = [json.dumps(mod.pascal_voc_metrics(gts, dets, 0.5, method), sort_keys=True,
                                   default=lambda a: np.asarray(a).tolist())
                        for method in ("every_point", "eleven_point")]
        mod.write_padilla_dirs(gts, dets, str(tmp_path / out / "gt"), str(tmp_path / out / "det"))
        results[out].append([[dataclasses.astuple(b) for b in part] for part in
                             mod.read_padilla_dirs(str(tmp_path / out / "gt"), str(tmp_path / out / "det"))])
    assert results["t"] == results["j"]
    for sub in ("gt", "det"):
        files = sorted(f.name for f in (tmp_path / "j" / sub).iterdir())
        assert files == sorted(f.name for f in (tmp_path / "t" / sub).iterdir()) and files
        for name in files:
            assert (tmp_path / "t" / sub / name).read_bytes() == (tmp_path / "j" / sub / name).read_bytes()
    gt = {img: b[:4].tolist() for img, b in images.items()}
    pred = {img: {"boxes": (b + 1).tolist(), "scores": rng.rand(6).tolist()} for img, b in images.items()}
    assert tcoco.coco_map(gt, pred) == jcoco.coco_map(gt, pred)
    for mod, out in ((tcoco, "t"), (jcoco, "j")):
        mod.write_box_jsons(gt, pred, str(tmp_path / f"{out}gt.json"), str(tmp_path / f"{out}pred.json"))
    for name in ("gt.json", "pred.json"):
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes()


def test_regions_and_gt_eval_equal_jax(tmp_path):
    """DS9 files byte for byte (colors, tags, border and merged flags,
    contours under 3 points skipped); ground-truth merging and per-image
    matching with the same tables."""
    rng = np.random.RandomState(10)
    objs = []
    for i in range(8):
        polys = [rng.uniform(0, 100, (rng.randint(2, 7), 2)).tolist() for _ in range(rng.randint(0, 3))]
        objs.append({"name": f"S{i + 1}", "class_name": ("sidelobe", "source", "galaxy", "unknown")[i % 4],
                     "edge": bool(i % 3 == 0), "merged": bool(i % 4 == 1), "vertexes": polys})
    for mod, out in ((tregions, "t.reg"), (jregions, "j.reg")):
        mod.write_ds9_regions(mod.make_regions_from_objs(objs, {"galaxy": "blue"}), str(tmp_path / out))
    assert (tmp_path / "t.reg").read_bytes() == (tmp_path / "j.reg").read_bytes()
    names = ("bkg", "sidelobe", "source", "galaxy")
    for _ in range(6):
        gt = _blob_masks(rng, 40, 40, 6)
        gt_ids = rng.randint(1, 4, 6)
        got, ref = tgt_eval.extract_gt_masks(gt, gt_ids), jgt_eval.extract_gt_masks(gt, gt_ids)
        assert got[1:] == ref[1:]
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_array_equal(a, b)
        dets = [m.astype(np.uint8) for m in np.moveaxis(_blob_masks(rng, 40, 40, 5), -1, 0)]
        det_ids, det_scores = list(rng.randint(1, 4, 5)), list(rng.rand(5))
        evs = [mod.evaluate_image(g[0], g[1], dets, det_ids, det_scores, names, iou_thr=0.3)
               for mod, g in ((tgt_eval, got), (jgt_eval, ref))]
        for field in dataclasses.fields(evs[1]):
            np.testing.assert_array_equal(getattr(evs[0], field.name), getattr(evs[1], field.name))


def test_native_mask_ops_equal_jax(jax_native):
    """mask_iou and masks_connected: equal to the JAX package's library and
    to the numpy versions (``analysis/masks.py``) on seeded mask pairs."""
    assert tnative.available() == jax_native.available()
    rng = np.random.RandomState(11)
    for _ in range(40):
        h, w = rng.randint(1, 30, 2)
        a, b = (rng.rand(2, h, w) < rng.uniform(0.02, 0.5)).astype(np.uint8)
        assert tnative.mask_iou(a, b) == jax_native.mask_iou(a, b) == tmasks.mask_iou(a, b)
        assert tnative.masks_connected(a, b) == jax_native.masks_connected(a, b)
        d = ndimage.binary_dilation(a.astype(bool), structure=np.ones((3, 3), bool))
        assert tnative.masks_connected(a, b) == bool(np.any(d & b.astype(bool)))


TRAIN_ALL_ARGVS = [
    ["train", "--dataset", "list.dat"],
    ["train", "--dataset", "list.dat", "--weights", "mrcnn.h5", "--weighttype", "coco", "--nepochs", "3",
     "--epoch_length", "7", "--nvalidation_steps", "2", "--ngpu", "1", "--nimg_per_gpu", "4", "--nthreads", "3"],
    ["train", "--dataset", "list.dat", "--weights", "w.pt", "--weighttype", "imagenet", "--logs", "out/"],
    ["test", "--dataset", "list.dat", "--nimg_test", "5", "--scoreThr_test", "0.5", "--iouThr_test", "0.3"],
    ["test", "--dataset", "list.dat", "--weights", "w.pt", "--weighttype", "COCO"],
]


@pytest.mark.parametrize("argv", TRAIN_ALL_ARGVS, ids=lambda a: " ".join(a[:1] + a[3:5]))
def test_train_all_translate_equals_jax(argv):
    """The legacy flags parse to the same values and translate to the same
    main-CLI argv."""
    got, ref = ttrain_all.parse_args(argv), jtrain_all.parse_args(argv)
    assert vars(got) == vars(ref)
    assert ttrain_all.translate(got) == jtrain_all.translate(ref)


@pytest.mark.parametrize("argv", [["detect", "--dataset", "list.dat"], ["train"]])
def test_train_all_translate_refuses_as_jax(argv):
    errors = []
    for mod in (ttrain_all, jtrain_all):
        with pytest.raises(ValueError) as err:
            mod.translate(mod.parse_args(argv))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _assert_sky_close(got, ref):
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=4 * np.spacing(np.abs(ref).max()))


SKIES = {
    "64 seed 11": (64, 11, {}),
    "128 seed 3": (128, 3, {}),
    "256 sidelobe-heavy": (256, 100, dict(sidelobe_spoke_p=1.0, sidelobe_src_snr=15.0, sidelobe_arc_p=0.6)),
}


@pytest.mark.parametrize("case", list(SKIES))
def test_sky_simulator_equals_jax(case):
    """The same seed draws the same skies: the image within 4 ulps of its
    largest value, every object's mask, class and SNR exactly."""
    size, seed, kw = SKIES[case]
    sims = tsynthetic.SkySimulator(size, seed, **kw), jsynthetic.SkySimulator(size, seed, **kw)
    n_objs = 0
    for _ in range(4):
        (img, objs), (ref_img, ref_objs) = (sim.sample() for sim in sims)
        _assert_sky_close(img, ref_img)
        assert [(o["class"], o["snr"]) for o in objs] == [(o["class"], o["snr"]) for o in ref_objs]
        for o, r in zip(objs, ref_objs):
            np.testing.assert_array_equal(o["mask"], r["mask"])
        n_objs += len(objs)
    assert n_objs > 0


def test_gaussian_blur_equals_cv2():
    """The port's blur against ``cv2.GaussianBlur`` on seeded white noise at
    the simulator's kernel sizes (and an image smaller than the kernel's
    reach on one side)."""
    import cv2

    rng = np.random.RandomState(12)
    for shape in ((256, 256), (40, 90)):
        for _ in range(4):
            white = rng.normal(0.0, 1.0, shape).astype(np.float32)
            sy, sx = rng.uniform(3.5, 6.0, 2) / 2.3548
            k = int(2 * np.ceil(3 * max(sy, sx)) + 1)
            _assert_sky_close(tsynthetic.gaussian_blur(white, k, sx, sy),
                              cv2.GaussianBlur(white, (k, k), sigmaX=sx, sigmaY=sy))


def test_write_survey_equals_jax(tmp_path):
    """The same files: the list, the json descriptors and the mask FITS
    byte for byte, the image FITS with the same header and values within 4
    ulps."""
    for mod, out in ((tsynthetic, "t"), (jsynthetic, "j")):
        lst = mod.write_survey(str(tmp_path / out), 3, seed=5, size=128, prefix="sky")
        assert lst == str(tmp_path / out / "datalist.dat")
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "t").iterdir()) and len(names) > 7
    t_list = (tmp_path / "t" / "datalist.dat").read_text()
    assert t_list == (tmp_path / "j" / "datalist.dat").read_text().replace(str(tmp_path / "j"), str(tmp_path / "t"))
    for name in names:
        got, ref = (tmp_path / "t" / name).read_bytes(), (tmp_path / "j" / name).read_bytes()
        if name == "datalist.dat":  # absolute paths, compared above
            continue
        if name.endswith(".fits") and "_m" not in name:  # an image
            assert got[:2880] == ref[:2880]
            _assert_sky_close(tfits.read_fits_data(str(tmp_path / "t" / name))[0],
                              jfits.read_fits_data(str(tmp_path / "j" / name))[0])
        else:
            assert got == ref, name
