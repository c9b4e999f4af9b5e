"""The machine with the card has no jax, flax, optax, orbax, cv2 or
matplotlib, and the port keeps its own copies of the host modules it needs.
These tests hold the port (``caesar_mrcnn_tpu_torch`` and ``chip_smoke.py``)
to running without those packages and without the JAX package
``caesar_mrcnn_tpu``, and check that nothing falls back to the CPU or to a
plain version where CUDA was asked for.
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
from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align, roi_align_backward

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

BLOCK_IMPORTS = """
import sys

class _Blocked:
    names = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "matplotlib", "caesar_mrcnn_tpu"}

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is not available to the port")
        return None

sys.meta_path.insert(0, _Blocked())
"""

SLICE = """
import importlib, pkgutil
import numpy as np
import caesar_mrcnn_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
cfg = inference_config(detector_config(
    backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
    pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=8,
    compute_dtype="float32"))
det = build_detector(cfg, seed=0, device="cpu")
res = det.detect_tiles(np.random.RandomState(0).randint(0, 255, (1, 64, 64), np.uint8))
assert len(res) == 1 and res[0]["masks"].shape[:2] == (64, 64)
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


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_and_runs_without_jax_cv2_matplotlib():
    """Every module of the port and chip_smoke.py import, and the detect
    slice runs, with jax, flax, optax, orbax, cv2, matplotlib and the JAX
    package ``caesar_mrcnn_tpu`` blocked."""
    proc = _run(["-c", BLOCK_IMPORTS + SLICE], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "slice ok" in proc.stdout


def test_training_path_imports_and_steps_without_jax_cv2_matplotlib():
    """trainer, generator and targets import, and one train step runs, with
    jax, flax, optax, orbax, cv2, matplotlib and ``caesar_mrcnn_tpu``
    blocked."""
    proc = _run(["-c", BLOCK_IMPORTS + TRAIN], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train ok" in proc.stdout


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
    """No module of the port imports ``caesar_mrcnn_tpu`` or a module under
    it, by absolute import, and the re-export module ``host`` is gone."""
    pkg = REPO / "caesar_mrcnn_tpu_torch"
    assert not (pkg / "host.py").exists()
    offending = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            offending += [f"{path.relative_to(REPO)}: {m}" for m in mods if m.split(".")[0] == "caesar_mrcnn_tpu"]
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
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises."""
    boxes = torch.zeros(2, 16, 4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        nms_padded(boxes, torch.zeros(2, 16, device="meta"), 8, 0.5)
    levels = [torch.zeros(2, s, s, 8, device="meta") for s in (16, 8, 4, 2)]
    with pytest.raises(RuntimeError, match="no kernel"):
        roi_align(levels, boxes, (64, 64), 7)
    with pytest.raises(RuntimeError, match="no kernel"):
        roi_align_backward(torch.zeros(2, 16, 7, 7, 8, device="meta"), boxes, [(16, 16)] * 4, (64, 64))
    masks = torch.zeros(2, 16, 16, 3, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        crop_and_resize(masks, boxes, torch.zeros(2, 16, dtype=torch.long, device="meta"), (4, 4))


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
