"""The port's serving export (``caesar_mrcnn_tpu_torch/inference/export.py``)
against the JAX package's (``caesar_mrcnn_tpu/inference/export.py``), on
the CPU at ``tests/test_export.py``'s configuration: custom backbone, 64^2,
batch 2, 4 classes, f32, ``PRNGKey(0)`` weights (``init_model``'s, jitted)
with the classifier's bias set to ``[0, 0, 6, 0]``, carried to the port by
``weights.flax_to_state_dict``.

* the port's artifact through its ``ServingDetector`` against JAX's
  artifact through JAX's, at ``tests/test_export.py``'s tolerances (class
  ids equal, scores within 1e-5, pixel boxes within 1, mask shapes equal),
  float and int8 (both from one quantized tree: the JAX ``Detector``'s
  calibration, used by the port through ``Detector.use_qtree``);
* the port's artifact against the port's live ``Detector`` on the same
  batch, bit for bit: the loaded program runs the same ATen operators and
  the same ``caesar`` operators in the same order;
* the exported graphs' ``caesar::*`` nodes: 2 NMS and 2 ROIAlign, and in
  the int8 graph one ``conv2d_int8`` per site and one ``quantize_int8``
  per input that no convolution quantized in its epilogue; no profiler
  node (the telemetry spans of ``forward_inference`` add none while
  recording is off);
* the sidecar, partial batches, the size and count checks, the zero-area
  drop, the refusal of an int8 detector with no int8 graph, and
  ``torch.library.opcheck`` of the seven operators;
* a ``ServingDetector`` in a subprocess with the model code
  (``caesar_mrcnn_tpu_torch.models``, ``.config``, ``.weights``), jax and
  the JAX package blocked from import.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.config import detector_config as j_detector_config
from caesar_mrcnn_tpu.config import inference_config as j_inference_config
from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
from caesar_mrcnn_tpu.inference.export import ServingDetector as JaxServingDetector
from caesar_mrcnn_tpu.inference.export import export_detector as jax_export_detector
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch import kernel_bench
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.inference.export import ServingDetector, caesar_nodes, export_detector
from caesar_mrcnn_tpu_torch.testing import op_cases

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
KW = dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
          class_names=("bkg", "sidelobe", "source", "galaxy"), rpn_anchor_scales=(8, 16, 32, 64, 128),
          pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=8, compute_dtype="float32")
JAX_SIDECAR = {"image_shape", "batch_size", "num_classes", "class_names", "detection_max_instances",
               "mask_wire_dtype", "mean_pixel", "quant_mode", "platforms", "jax_version"}


def _images(seed, n=2):
    rng = np.random.RandomState(seed)
    return [rng.rand(64, 64, 3).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    """(JAX config, model, numpy variables) of ``tests/test_export.py``:
    ``init_model``'s module and ``PRNGKey(0)`` initialization, jitted (the
    eager ``init_model`` takes half a minute here)."""
    jcfg = j_inference_config(j_detector_config(**KW), images_per_device=2, num_devices=1)
    model = JaxMaskRCNN(jcfg)
    dummy = jnp.zeros((1,) + jcfg.image_shape, jnp.float32)
    variables = jax.jit(lambda key: model.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    cb = v["params"]["classifier_head"]["mrcnn_class_logits"]["bias"]
    cb[:] = 0.0
    cb[2] = 6.0
    return jcfg, model, v


def _export_both(jdet, tdet, root, name):
    jpath, tpath = str(root / f"{name}.stablehlo"), str(root / f"{name}.pt2")
    jax_export_detector(jdet, jpath)
    export_detector(tdet, tpath)
    return jpath, tpath


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """{"float", "int8"}: (JAX Detector, JAX artifact, port Detector, port
    artifact); the int8 pair shares the JAX Detector's quantized tree."""
    jcfg, jmodel, v = weights
    root = tmp_path_factory.mktemp("export")
    cfg = tconfig.Config(**dataclasses.asdict(jcfg))
    out = {}
    jdet, tdet = JaxDetector(jcfg, jmodel, v), build_detector(cfg, device="cpu", weights=v)
    jpath, tpath = _export_both(jdet, tdet, root, "float")
    out["float"] = (jdet, jpath, tdet, tpath)
    jdet, tdet = JaxDetector(jcfg, jmodel, v), build_detector(cfg, device="cpu", weights=v)
    jdet.quantize(_images(5))
    tdet.use_qtree(jax.tree_util.tree_map(np.asarray, jax.device_get(jdet.variables["quant"])))
    jpath, tpath = _export_both(jdet, tdet, root, "int8")
    out["int8"] = (jdet, jpath, tdet, tpath)
    return out


@pytest.fixture(scope="module")
def servers(exported):
    """{"float", "int8"}: the port's artifact, loaded by ``ServingDetector``."""
    return {graph: ServingDetector(tpath, device="cpu") for graph, (_, _, _, tpath) in exported.items()}


def test_export_writes_artifact_and_sidecar(exported):
    jdet, jpath, tdet, tpath = exported["float"]
    assert os.path.getsize(tpath) > 1000
    meta, jmeta = (json.loads(Path(p + ".json").read_text()) for p in (tpath, jpath))
    assert set(meta) == JAX_SIDECAR - {"platforms", "jax_version"} | {"device", "torch_version"}
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    for key in JAX_SIDECAR - {"platforms", "jax_version"}:
        assert meta[key] == jmeta[key], key
    assert meta["image_shape"] == [64, 64, 3] and meta["batch_size"] == 2 and meta["class_names"][2] == "source"
    assert json.loads(Path(exported["int8"][3] + ".json").read_text())["quant_mode"] == "int8"


@pytest.mark.parametrize("graph", ["float", "int8"])
def test_serving_detector_matches_jax(exported, servers, graph):
    images = _images(0)
    ref, got = JaxServingDetector(exported[graph][1]).detect(images), servers[graph].detect(images)
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        assert len(g["class_ids"]) > 0
        np.testing.assert_array_equal(r["class_ids"], g["class_ids"])
        np.testing.assert_allclose(r["scores"], g["scores"], atol=1e-5)
        np.testing.assert_allclose(r["rois"], g["rois"], atol=1)
        assert r["masks"].shape == g["masks"].shape


@pytest.mark.parametrize("graph", ["float", "int8"])
def test_serving_detector_equals_live_detector_bitwise(exported, servers, graph):
    """The loaded program's raw outputs equal ``Detector._step``'s on the
    same molded batch, and ``detect`` the live ``Detector.detect``."""
    tdet, srv = exported[graph][2], servers[graph]
    images = _images(1)
    molded = np.stack(images) - np.asarray(srv.meta["mean_pixel"], np.float32)
    anchors, metas = tdet._constants((64, 64, 3))
    live = tdet._step(torch.from_numpy(molded), metas, anchors)
    served = srv._call(molded)
    assert (graph == "int8") == (tdet.int8_graph() is not None)
    for a, b in zip((live.detections, live.masks), served):
        assert a.dtype == torch.from_numpy(b).dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tdet.detect(images), srv.detect(images)):
        for key in ("rois", "class_ids", "scores", "masks"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_exported_graphs_hold_the_kernel_operators(servers, weights):
    """Each artifact, as loaded, calls the port's kernels as operators: 2
    NMS (proposals, detections) and 2 ROIAlign (pool 7 and 14); the int8
    graph also one convolution per site and one quantizer per input that
    no convolution before it requantized (the sites' own walk,
    ``kernel_bench.int8_sites``)."""
    jcfg = weights[0]
    sites = kernel_bench.int8_sites(tconfig.Config(**dataclasses.asdict(jcfg)), jcfg.post_nms_rois_inference,
                                    jcfg.detection_max_instances)
    fused = {s.then for s in sites if s.then}
    assert len(sites) == 60 and len(fused) == 28
    expected = {"float": {"nms": 2, "roi_align": 2},
                "int8": {"nms": 2, "roi_align": 2, "conv2d_int8": len(sites), "quantize_int8": len(sites) - len(fused)}}
    for graph, want in expected.items():
        assert caesar_nodes(servers[graph].program) == want, graph
        # exported with telemetry off: no record_function of a span in the graph
        assert not [n for n in servers[graph].program.graph.nodes if "profiler" in str(n.target)], graph


def test_serving_detector_partial_batch_and_validation(servers):
    srv = servers["float"]
    rng = np.random.RandomState(1)
    one = srv.detect([rng.rand(64, 64, 3).astype(np.float32)])
    assert len(one) == 1 and one[0]["masks"].shape[:2] == (64, 64)
    with pytest.raises(ValueError, match="pre-sized"):
        srv.detect([rng.rand(32, 32, 3).astype(np.float32)])
    with pytest.raises(ValueError, match="expected 1..2"):
        srv.detect([])
    with pytest.raises(ValueError, match="expected 1..2"):
        srv.detect(_images(2, n=3))


def test_serving_detector_drops_zero_area_boxes(servers, monkeypatch):
    """``tests/test_export.py``'s case: a box that collapses to zero pixel
    area after denorm rounding is dropped before ``unmold_mask``."""
    srv = servers["float"]
    b, d = srv.batch_size, srv.meta["detection_max_instances"]

    def fake_call(molded):
        det = np.zeros((b, d, 6), np.float32)
        det[:, 0] = [0.1, 0.1, 0.5, 0.5, 2, 0.9]
        det[:, 1] = [0.25, 0.2, 0.15, 0.6, 2, 0.8]  # y2 < y1
        return det, np.full((b, d, 28, 28), 255, np.uint8)

    monkeypatch.setattr(srv, "_call", fake_call)
    out = srv.detect(_images(2, n=1))
    assert out[0]["rois"].shape[0] == 1 and out[0]["masks"].shape == (64, 64, 1) and out[0]["masks"].any()


def test_serving_detector_refuses_another_device(exported, monkeypatch):
    with pytest.raises(ValueError, match="exported on cpu"):
        ServingDetector(exported["float"][3], device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingDetector(exported["float"][3])


def test_export_refuses_int8_detector_without_int8_graph(weights, tmp_path):
    """The deliberate difference from the JAX package, which exports the
    float graph here: an int8 detector is exported only once calibrated,
    and not after its weights changed."""
    jcfg, _, v = weights
    det = build_detector(tconfig.Config(**dataclasses.asdict(jcfg)).replace(quant_mode="int8"), device="cpu",
                         weights=v)
    with pytest.raises(ValueError, match=r"Detector\.quantize"):
        export_detector(det, str(tmp_path / "a.pt2"))
    det.quantize(_images(5))
    with torch.no_grad():
        det.model.backbone.conv1.weight.mul_(0.5)
    with pytest.raises(ValueError, match=r"Detector\.quantize"):
        export_detector(det, str(tmp_path / "a.pt2"))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("case", [label for label, _, _ in op_cases("cpu")])
def test_opcheck_on_the_cpu(case):
    """Schema, fake implementation (shapes, dtypes, strides), autograd
    registration and tracing under dynamic shapes, for every operator."""
    (_, op, args), = [c for c in op_cases("cpu") if c[0] == case]
    torch.library.opcheck(op, args)


SERVE = """
import json, sys
import numpy as np

BLOCKED = ("jax", "jaxlib", "caesar_mrcnn_tpu", "caesar_mrcnn_tpu_torch.models", "caesar_mrcnn_tpu_torch.config",
           "caesar_mrcnn_tpu_torch.weights")

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
from caesar_mrcnn_tpu_torch.inference.export import ServingDetector
srv = ServingDetector(sys.argv[1], device="cpu")
rng = np.random.RandomState(0)
out = srv.detect([rng.rand(64, 64, 3).astype(np.float32) for _ in range(2)])
loaded = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not loaded, loaded
print(json.dumps([{k: r[k].tolist() for k in ("rois", "class_ids", "scores")} for r in out]))
"""


def test_serving_detector_runs_without_the_model_code(exported, servers):
    """A fresh process loads the int8 artifact and detects with the model
    code, the config, the weights module, jax and the JAX package blocked;
    its results equal this process's."""
    path = exported["int8"][3]
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", SERVE, path], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = servers["int8"].detect(_images(0))
    assert len(got) == 2 and all(len(g["class_ids"]) > 0 for g in got)
    for g, r in zip(got, ref):
        for key in ("rois", "class_ids", "scores"):
            np.testing.assert_array_equal(np.asarray(g[key], r[key].dtype), r[key], err_msg=key)
