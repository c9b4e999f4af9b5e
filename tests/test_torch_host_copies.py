"""The port's copies of the JAX package's host modules against their
originals, on the CPU, on seeded inputs: the configuration and its presets,
the anchors, FITS writing and reading, zscale, tiling, the augmentations,
the debug ROIs, the dataset and the native host library.

Every comparison is exact: the copies run the same numpy code, and the two
native libraries are built from the same C++ with the same flags. The JAX
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

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu import native as jnative
from caesar_mrcnn_tpu.data import augment as jaugment
from caesar_mrcnn_tpu.data import dataset as jdataset
from caesar_mrcnn_tpu.models import debug_rois as jdebug
from caesar_mrcnn_tpu.utils import anchors as janchors
from caesar_mrcnn_tpu.utils import fits as jfits
from caesar_mrcnn_tpu.utils import tiles as jtiles
from caesar_mrcnn_tpu.utils import zscale as jzscale
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch import native as tnative
from caesar_mrcnn_tpu_torch.data import augment as taugment
from caesar_mrcnn_tpu_torch.data import dataset as tdataset
from caesar_mrcnn_tpu_torch.models import debug_rois as tdebug
from caesar_mrcnn_tpu_torch.utils import anchors as tanchors
from caesar_mrcnn_tpu_torch.utils import fits as tfits
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
