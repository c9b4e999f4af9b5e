"""The machine with the card has no jax, flax, optax, orbax, cv2, networkx or
matplotlib, and may lack h5py; the port keeps its own copies of the host
modules it needs. These tests hold the port (``caesar_mrcnn_tpu_torch`` and
``chip_smoke.py``) to running without those packages and without the JAX
package ``caesar_mrcnn_tpu`` (h5py is imported only inside the functions
that read or write a ``.h5`` file), and check that nothing falls back to
the CPU or to a plain version where CUDA was asked for.
"""

import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from caesar_mrcnn_tpu_torch.ops import _kernels
from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
from caesar_mrcnn_tpu_torch.ops.quant import conv2d_int8, quantize_int8
from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align, roi_align_backward

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

# what the card's machine lacks, and the JAX package: imported nowhere in the port
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "networkx", "matplotlib", "caesar_mrcnn_tpu"}
# and what the subprocesses also run without
BLOCKED_IN_SUBPROCESS = BLOCKED | {"h5py"}

BLOCK_IMPORTS = """
import sys

class _Blocked:
    names = %r

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is not available to the port")
        return None

sys.meta_path.insert(0, _Blocked())
""" % (BLOCKED_IN_SUBPROCESS,)

SLICE = """
import importlib, json, os, pkgutil, tempfile
import numpy as np
import caesar_mrcnn_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
from caesar_mrcnn_tpu_torch.analysis.sfinder import SFinder
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.testing import pin_heads
cfg = inference_config(detector_config(
    backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
    class_names=chip_smoke.CLASS_NAMES, pre_nms_limit=128, post_nms_rois_inference=32,
    detection_max_instances=8, compute_dtype="float32", tile_xsize=64, tile_ysize=64))
det = build_detector(cfg, seed=0, device="cpu")
res = det.detect_tiles(np.random.RandomState(0).randint(0, 255, (1, 64, 64), np.uint8))
assert len(res) == 1 and res[0]["masks"].shape[:2] == (64, 64)
det8 = build_detector(cfg.replace(quant_mode="int8"), seed=0, device="cpu")
res = det8.detect_tiles(np.random.RandomState(0).randint(0, 255, (1, 64, 64), np.uint8))
assert len(res) == 1 and det8.qtree is not None and len(det8.qtree) == 60
pin_heads(det.model)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "mosaic.fits")
    chip_smoke.write_mosaic(path, n=128)
    sf = SFinder(det, cfg)
    sf.outfile_json, sf.outfile_ds9 = os.path.join(tmp, "c.json"), os.path.join(tmp, "c.reg")
    catalog = sf.run_tiled(path)
    with open(sf.outfile_json) as f:
        assert len(json.load(f)["objs"]) == len(catalog["objs"]) > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _Blocked.names)
assert not loaded, loaded
print("slice ok")
"""

TRAIN = """
import tempfile
import numpy as np
import torch
import caesar_mrcnn_tpu_torch.train.trainer as T
import caesar_mrcnn_tpu_torch.data.generator as G
import caesar_mrcnn_tpu_torch.models.targets as TT
import caesar_mrcnn_tpu_torch.train.checkpoints
import chip_smoke
from caesar_mrcnn_tpu_torch.config import detector_config
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
cfg = detector_config(
    backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4, images_per_device=2,
    class_names=chip_smoke.CLASS_NAMES, rpn_anchor_scales=(8, 16, 32, 64, 128), pre_nms_limit=128,
    post_nms_rois_training=32, train_rois_per_image=16, rpn_train_anchors_per_image=32,
    max_gt_instances=4, compute_dtype="float32")
with tempfile.TemporaryDirectory() as tmp:
    ds = chip_smoke.load_train_dataset(chip_smoke.write_train_dataset(tmp, n_images=2, size=64, objects=2))
    pipe = G.TrainingPipeline(ds, cfg, seed=0)
    batch = next(pipe.batches())
model = MaskRCNN(cfg)
step = T.make_train_step(model, T.make_optimizer(cfg, model), pipe.anchors_normalized())
losses = step(T.batch_to_device(batch, "cpu"), generator=torch.Generator().manual_seed(0))
assert all(bool(torch.isfinite(v)) for v in losses.values()), losses
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _Blocked.names)
assert not loaded, loaded
print("train ok")
"""


CLI = """
import json, os, tempfile
import chip_smoke
from caesar_mrcnn_tpu_torch.cli import run as cli
tiny = ["--imgsize", "64", "--backbone", "custom", "--rpn_anchor_scales", "8,16,32,64,128",
        "--rpn_train_anchors_per_image", "32", "--train_rois_per_image", "16", "--max_gt_instances", "4",
        "--pre_nms_limit", "128", "--post_nms_rois_training", "32", "--post_nms_rois_inference", "32",
        "--detection_max_instances", "8", "--nimg_per_gpu", "2", "--device", "cpu"]
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    listfile = os.path.join(tmp, "list")
    with open(listfile, "w") as f:
        f.write("\\n".join(chip_smoke.write_train_dataset(tmp, n_images=2, size=64, objects=2)))
    assert cli.main(["train", "--dataloader", "datalist_json", "--datalist_train", listfile, "--datalist_val",
                     listfile, "--epoch_length", "1", "--nvalidation_steps", "0", "--logs", "logs"] + tiny) == 0
    weights = os.path.join(tmp, "logs", "mask_rcnn_rg-dataset_0001.pt")
    chip_smoke.write_mosaic(os.path.join(tmp, "mosaic.fits"), n=128)
    assert cli.main(["detect", "--image", "mosaic.fits", "--split_img_in_tiles", "--tile_xsize", "64",
                     "--tile_ysize", "64", "--weights", weights, "--scoreThr", "0.0", "--detect_outfile_json",
                     "catalog.json"] + tiny) == 0
    with open("catalog.json") as f:
        assert "objs" in json.load(f)
    assert os.path.isfile("ds9_mosaic.reg")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _Blocked.names)
assert not loaded, loaded
print("cli ok")
"""


HOST = """
import json, os, tempfile
import numpy as np
from caesar_mrcnn_tpu_torch.cli import eval_map, eval_voc, sclassifier
from caesar_mrcnn_tpu_torch.config import detector_config
from caesar_mrcnn_tpu_torch.data.synthetic import write_survey
from caesar_mrcnn_tpu_torch.evalmetrics.voc import BBox, write_padilla_dirs
from caesar_mrcnn_tpu_torch.utils import fits as F
# the CLI's config narrowed to a small detector (it has no flags for these)
sclassifier.detector_config = lambda **kw: detector_config(**kw, backbone="custom", pre_nms_limit=128,
                                                           post_nms_rois_inference=32, detection_max_instances=8)
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    data = np.random.RandomState(1).normal(0, 0.01, (200, 200)).astype(np.float32)
    data[90:110, 90:110] += 5.0
    F.write_fits(data, "img.fits")
    with open("cat.dat", "w") as f:
        f.write("S1 0 0 0 0 100 100 0 0 0 0 0 0 90 110 90 110 0\\n")
    assert sclassifier.main(["--image", "img.fits", "--scatalog", "cat.dat", "--scutout_size", "64",
                             "--device", "cpu", "--scoreThr", "0.0"]) == 0
    with open("sclass_catalog.dat") as f:
        assert f.read().splitlines()[1].startswith("S1 100.0 100.0 ")
    boxes = [BBox("a", "source", (10, 10, 20, 20)), BBox("a", "galaxy", (50, 50, 80, 80))]
    write_padilla_dirs(boxes, [BBox(b.image_id, b.class_name, b.box, 0.9) for b in boxes], "gt", "det")
    assert eval_voc.main(["-gt", "gt", "-det", "det"]) == 0
    with open("results/results.txt") as f:
        assert "mAP: 100.00%" in f.read()
    with open("gt.json", "w") as f:
        json.dump({"a": [[10, 10, 20, 20]]}, f)
    with open("pred.json", "w") as f:
        json.dump({"a": {"boxes": [[10, 10, 20, 20]], "scores": [0.9]}}, f)
    assert eval_map.main(["--gt", "gt.json", "--pred", "pred.json"]) == 0
    lst = write_survey(os.path.join(tmp, "sky"), 2, seed=3, size=64)
    with open(lst) as f:
        assert len(f.read().split()) == 2
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _Blocked.names)
assert not loaded, loaded
print("host ok")
"""


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_and_runs_without_jax_cv2_matplotlib():
    """Every module of the port and chip_smoke.py import, and the detect
    slice (float and int8) and ``SFinder.run_tiled`` over a 2 x 2-tile
    mosaic run (the catalog written), with jax, flax, optax, orbax, cv2, networkx,
    matplotlib, h5py and the JAX package ``caesar_mrcnn_tpu`` blocked."""
    proc = _run(["-c", BLOCK_IMPORTS + SLICE], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "slice ok" in proc.stdout


def test_training_path_imports_and_steps_without_jax_cv2_matplotlib():
    """trainer, generator and targets import, and one train step runs, with
    jax, flax, optax, orbax, cv2, networkx, matplotlib, h5py and
    ``caesar_mrcnn_tpu`` blocked."""
    proc = _run(["-c", BLOCK_IMPORTS + TRAIN], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train ok" in proc.stdout


def test_cli_trains_and_detects_without_jax_cv2_matplotlib_h5py():
    """The port's CLI trains one step (a ``.pt`` checkpoint) and detects on
    a 2 x 2-tile mosaic from it (the catalog and DS9 file written) on the
    CPU, with jax, flax, optax, orbax, cv2, networkx, matplotlib, h5py and
    ``caesar_mrcnn_tpu`` blocked."""
    proc = _run(["-c", BLOCK_IMPORTS + CLI], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cli ok" in proc.stdout


def test_classifier_eval_and_synthetic_without_jax_cv2_matplotlib_h5py():
    """The classifier CLI classifies a catalog source on the CPU, both eval
    CLIs write their results, and ``write_survey`` writes a synthetic sky,
    with jax, flax, optax, orbax, cv2, networkx, matplotlib, h5py and
    ``caesar_mrcnn_tpu`` blocked."""
    proc = _run(["-c", BLOCK_IMPORTS + HOST], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "host ok" in proc.stdout


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: every module it imports is the
    standard library, numpy, torch or ``caesar_mrcnn_tpu_torch``, and none
    is a module of the JAX package ``caesar_mrcnn_tpu``."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert "caesar_mrcnn_tpu_torch.config" in names
    assert not {n for n in names if n.split(".")[0] == "caesar_mrcnn_tpu"}
    tops = {n.split(".")[0] for n in names}
    foreign = tops - set(sys.stdlib_module_names) - {"numpy", "torch", "caesar_mrcnn_tpu_torch"}
    assert not foreign, foreign


def test_port_sources_import_nothing_of_the_jax_package():
    """No module of the port (nor chip_smoke.py) imports ``caesar_mrcnn_tpu``
    or a module under it, or jax, flax, optax, orbax, cv2, networkx or
    matplotlib, anywhere (inside functions too), by absolute import; and
    the re-export module ``host`` is gone."""
    pkg = REPO / "caesar_mrcnn_tpu_torch"
    assert not (pkg / "host.py").exists()
    offending = []
    for path in sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            offending += [f"{path.relative_to(REPO)}: {m}" for m in mods if m.split(".")[0] in BLOCKED]
    assert not offending, offending


def test_build_detector_defaults_to_the_card():
    from caesar_mrcnn_tpu_torch.inference.detector import build_detector

    assert inspect.signature(build_detector).parameters["device"].default == "cuda"


def _assert_refused(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_chip_smoke_refuses_to_run_without_cuda():
    _assert_refused(_run(["chip_smoke.py"], cwd=REPO, env_extra={"CUDA_VISIBLE_DEVICES": ""}))


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run(["chip_smoke.py"], cwd=tmp_path))


def test_wrappers_do_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. Every wrapper reaches its ``caesar`` operator, which
    has a CPU and a CUDA kernel and no other: no composite kernel that a
    device could fall back to, no kernel for another device, so the
    dispatcher refuses any other real device. On the meta device each gives
    its fake implementation's shapes and dtypes and computes nothing."""
    from caesar_mrcnn_tpu_torch.ops import library

    names = ("nms", "roi_align", "roi_align_backward", "crop_and_resize", "quantize_int8", "conv2d_int8")
    for name in names:
        qualname = f"{library.NAMESPACE}::{name}"
        have = {key for key in ("CPU", "CUDA", "Meta", "XPU", "MPS", "HIP", "PrivateUse1", "Lazy",
                                "CompositeExplicitAutograd", "CompositeImplicitAutograd")
                if torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key)}
        assert have == {"CPU", "CUDA", "Meta"}, (name, have)

    boxes = torch.zeros(2, 16, 4, device="meta")
    idx, valid = nms_padded(boxes, torch.zeros(2, 16, device="meta"), 8, 0.5)
    assert (idx.device.type, idx.dtype, idx.shape, valid.dtype) == ("meta", torch.int32, (2, 8), torch.bool)
    levels = [torch.zeros(2, s, s, 8, device="meta") for s in (16, 8, 4, 2)]
    assert roi_align(levels, boxes, (64, 64), 7).shape == (2, 16, 7, 7, 8)
    grads = roi_align_backward(torch.zeros(2, 16, 7, 7, 8, device="meta"), boxes, [(16, 16)] * 4, (64, 64))
    assert [g.shape for g in grads] == [(2, 16, 16, 8)] * 4 and grads[0].device.type == "meta"
    masks = torch.zeros(2, 16, 16, 3, device="meta")
    crops = crop_and_resize(masks, boxes, torch.zeros(2, 16, dtype=torch.long, device="meta"), (4, 6))
    assert crops.shape == (2, 16, 4, 6) and crops.device.type == "meta"
    q = quantize_int8(torch.zeros(2, 8, 8, 3, device="meta"), 0.5, channels=16)
    assert (q.device.type, q.dtype, q.shape) == ("meta", torch.int8, (2, 8, 8, 16))
    xq = torch.zeros(2, 8, 8, 16, dtype=torch.int8, device="meta")
    w = torch.zeros(4, 3, 3, 16, dtype=torch.int8, device="meta")
    out = conv2d_int8(xq, w, torch.ones(4, device="meta"), torch.zeros(4, device="meta"), 2, ((1, 1), (1, 1)),
                      s_next=0.5)
    assert (out.device.type, out.dtype, out.shape) == ("meta", torch.int8, (2, 4, 4, 4))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _kernels.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _kernels.library()
    finally:
        _kernels.library.cache_clear()
