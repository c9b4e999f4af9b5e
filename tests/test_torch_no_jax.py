"""The machine with the card has no jax, flax, optax, orbax, cv2 or
matplotlib. These tests hold the port (``caesar_mrcnn_tpu_torch`` and
``chip_smoke.py``) to that, and check that nothing falls back to the CPU or
to a plain version where CUDA was asked for.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from caesar_mrcnn_tpu_torch.ops import _kernels
from caesar_mrcnn_tpu_torch.ops.nms import nms_padded
from caesar_mrcnn_tpu_torch.ops.roi_align import roi_align

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

BLOCK_IMPORTS = """
import sys

class _Blocked:
    names = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "matplotlib"}

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is not installed on the card's machine")
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
from caesar_mrcnn_tpu.config import detector_config, inference_config
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


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_and_runs_without_jax_cv2_matplotlib():
    proc = _run(["-c", BLOCK_IMPORTS + SLICE], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "slice ok" in proc.stdout


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
