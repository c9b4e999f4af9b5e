"""The float detect graph's features replayed as a CUDA graph
(``caesar_mrcnn_tpu_torch/inference/graphed.py``) and the ``Detector``'s
rule for it.

On the CPU, at a small detector (custom backbone, 64^2, batch 2, 128 / 32
proposals, 8 detections, seed 0 weights):

* ``graphed.engages`` over device type x int8 graph: only the float graph
  on a CUDA device engages (the devices are ``torch.device`` objects, so
  the rule runs here for a CUDA one too);
* a CPU detector's step runs its model eagerly, and the counters stay
  unrecorded, on the tiled path and through ``detect``;
* with the rule made to take the CPU for a card, ``Detector._graph``
  hands out one ``GraphedFeatures`` a device, with the model's own
  ``config`` and later stages, the same one after ``load_state_dict``
  (which writes into the parameters the graph reads), one for each
  replica's own model over two devices, and never for an int8 detector;
  an int8 detector without an int8 graph gets no graph at all (it
  raises), and ``dispatch_tiles`` and ``detect`` calibrate it once per
  weights version, on the batch's real molded images;
* ``MaskRCNN.pyramid`` (the graph's capture) on the cast batch equals
  ``MaskRCNN.features`` bit for bit, in f32 and bf16;
* ``forward_train`` (with and without remat) and ``export_program`` still
  go through ``MaskRCNN.features``.

On the card (marker ``cuda``, skipped here): the graphed pyramid against
the eager ``MaskRCNN.features`` at the benchmark cell's shape (batch 8,
512^2, ResNet-101, bf16) and at a small f32 one; the tiled detector's
detections, masks and pasted frames against the same detector run
eagerly, two batches in flight and a padded partial batch; after
``load_state_dict``, the same graph replaying the new weights; two
replicas (on two cards where there are two, else both on one), each
replaying its own pyramid on three batches; no replay in an int8
detector. There, without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_graphed_features.py
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch import telemetry
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference import detector as D
from caesar_mrcnn_tpu_torch.inference import graphed as G
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.inference.export import export_program
from caesar_mrcnn_tpu_torch.models import mask_rcnn as M
from caesar_mrcnn_tpu_torch.models.heads_int8 import DetectStages
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
KW = dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
          class_names=("bkg", "sidelobe", "source", "galaxy"), rpn_anchor_scales=(8, 16, 32, 64, 128),
          pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=8, compute_dtype="float32")
COUNTERS = ("detect.features.graph_captures", "detect.features.graph_replays")


def _config(**overrides):
    return inference_config(detector_config(**dict(KW, **overrides)), images_per_device=2, num_devices=1)


@pytest.fixture(scope="module")
def det():
    return build_detector(_config(), device="cpu", seed=0)


def _tiles(seed, n=2, side=64):
    return np.random.RandomState(seed).randint(0, 255, (n, side, side), np.uint8)


def _as_if_cuda(monkeypatch):
    """Make the detector's rule take the CPU for a card."""
    engages = G.engages
    monkeypatch.setattr(D.G, "engages", lambda device, int8_graph: engages(
        torch.device("cuda") if device.type == "cpu" else device, int8_graph))


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_engage_rule(device, quant):
    int8_graph = None if quant == "none" else DetectStages.__new__(DetectStages)
    want = device.startswith("cuda") and quant == "none"
    assert G.engages(torch.device(device), int8_graph) is want


@pytest.mark.parametrize("path", ["dispatch_tiles", "detect"])
def test_cpu_detector_runs_its_model_eagerly(det, path):
    assert det._graph(0) is det.model
    with telemetry.recording() as rec:
        if path == "dispatch_tiles":
            det.collect(det.dispatch_tiles(_tiles(1)))
        else:
            det.detect([t[..., None].repeat(3, -1).astype(np.float32) for t in _tiles(2)])
    counters = rec.summary()["counters"]
    assert not set(COUNTERS) & set(counters) and not det._graphed


def test_detector_hands_out_one_graphed_stage_a_device(monkeypatch):
    det = build_detector(_config(), device="cpu", seed=0)
    _as_if_cuda(monkeypatch)
    staged = det._graph(0)
    assert isinstance(staged, G.GraphedFeatures) and staged.model is det.model
    assert staged.config is det.model.config
    assert (staged.rpn, staged.classifier, staged.mask) == (det.model.rpn, det.model.classifier, det.model.mask)
    assert det._graph(0) is staged
    other = build_detector(_config(), device="cpu", seed=1)
    det.model.load_state_dict(other.model.state_dict())
    assert det._graph(0) is staged and staged.model is det.model


def test_two_device_detector_hands_each_replica_its_own_graphed_stage(monkeypatch):
    cfg = inference_config(detector_config(**KW), images_per_device=1, num_devices=2)
    one = build_detector(_config(), device="cpu", seed=0)
    det = D.Detector(cfg, one.model, ["cpu", "cpu"])
    _as_if_cuda(monkeypatch)
    staged = [det._graph(i) for i in range(2)]
    assert [s.model for s in staged] == det._models and staged[0].model is not staged[1].model
    assert staged[1].rpn == det._models[1].rpn and [det._graph(i) for i in range(2)] == staged
    other = build_detector(_config(), device="cpu", seed=1)
    det.model.load_state_dict(other.model.state_dict())
    assert [det._graph(i) for i in range(2)] == staged  # the replica's weights loaded in place
    assert torch.equal(det._models[1].backbone.conv1.weight, other.model.backbone.conv1.weight)


def test_int8_detector_never_gets_the_graphed_stage(monkeypatch):
    det = build_detector(_config(quant_mode="int8"), device="cpu", seed=0)
    det.quantize([t[..., None].repeat(3, -1).astype(np.float32) for t in _tiles(3)])
    _as_if_cuda(monkeypatch)
    assert isinstance(det._graph(0), DetectStages) and not det._graphed


def test_uncalibrated_int8_detector_gets_no_graph(monkeypatch):
    det = build_detector(_config(quant_mode="int8"), device="cpu", seed=0)
    _as_if_cuda(monkeypatch)  # the int8 rule comes first: never the float features graph
    with pytest.raises(RuntimeError, match="no int8 graph"):
        det._graph(0)
    assert not det._graphed and det.int8_graph() is None


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for site in a:
        assert a[site].keys() == b[site].keys()
        for k in a[site]:
            assert np.array_equal(np.asarray(a[site][k]), np.asarray(b[site][k])), (site, k)


@pytest.mark.parametrize("path", ["dispatch_tiles", "detect"])
def test_int8_detector_calibrates_once_per_weights_version(path):
    """The first batch calibrates, on its one real image of two (the batch
    padded): the same tree as ``_quantize_molded`` on that image's molded
    batch; the next batch does not; after a write to the weights the next
    batch calibrates again."""
    det = build_detector(_config(quant_mode="int8"), device="cpu", seed=0)
    ref = build_detector(_config(quant_mode="int8"), device="cpu", seed=0)
    calls = []
    quantize_molded = det._quantize_molded

    def counted(molded, metas, anchors):
        calls.append(molded.shape)
        quantize_molded(molded, metas, anchors)

    det._quantize_molded = counted
    tiles = _tiles(16, n=1)
    images = [t[..., None].repeat(3, -1).astype(np.float32) for t in tiles]

    def run(tiles, images):
        if path == "dispatch_tiles":
            return det.collect(det.dispatch_tiles(tiles))
        return det.detect(images)

    run(tiles, images)
    assert calls == [(1, 64, 64, 3)]
    if path == "dispatch_tiles":
        molded = torch.from_numpy(tiles.astype(np.float32))[..., None].expand(-1, -1, -1, 3) - ref._mean
        metas = ref._constants((64, 64, 3))[1][:1]
    else:
        molded, metas, _ = (torch.from_numpy(a) for a in ref.mold_inputs(images))
    with torch.inference_mode():
        ref._quantize_molded(molded, metas, ref._constants((64, 64, 3))[0])
    _same_tree(det.qtree, ref.qtree)
    run(_tiles(17, n=2), list(images) * 2)
    assert len(calls) == 1
    with torch.no_grad():
        det.model.fpn.fpn_p2.bias.add_(0.0)  # a write in place: the int8 graph is dropped
    run(tiles, images)
    assert len(calls) == 2 and isinstance(det._graph(0), DetectStages)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_on_the_cast_batch_equals_model_features(dtype):
    det = build_detector(_config(compute_dtype=dtype), device="cpu", seed=0)
    images = torch.from_numpy(np.random.RandomState(4).normal(0, 50, (2, 64, 64, 3)).astype(np.float32))
    x = images.permute(0, 3, 1, 2)
    cast = torch.empty(x.shape, dtype=det.model.dtype, memory_format=torch.channels_last)
    cast.copy_(x)  # as GraphedFeatures._capture and .features fill the static input
    with torch.inference_mode():
        got = det.model.pyramid(cast)
        want = det.model.features(images)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == det.model.dtype and torch.equal(g, w)


@pytest.fixture()
def features_calls(monkeypatch):
    """Counts the calls of ``MaskRCNN.features``."""
    calls = []
    features = M.MaskRCNN.features

    def counted(self, images):
        calls.append(images.shape)
        return features(self, images)

    monkeypatch.setattr(M.MaskRCNN, "features", counted)
    return calls


@pytest.mark.parametrize("remat", ["none", "backbone"])
def test_forward_train_runs_model_features(features_calls, remat):
    cfg = detector_config(**dict(KW, images_per_device=2, num_devices=1, train_rois_per_image=16,
                                 post_nms_rois_training=32, max_gt_instances=2, use_mini_mask=True,
                                 mini_mask_shape=(28, 28), train_remat=remat))
    model = M.MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.RandomState(5).normal(0, 1, (2, 64, 64, 3)).astype(np.float32))
    gt_class_ids = torch.tensor([[2, 0], [3, 1]])
    gt_boxes = torch.tensor([[[0.1, 0.1, 0.4, 0.5], [0, 0, 0, 0]], [[0.2, 0.3, 0.6, 0.7], [0.5, 0.5, 0.9, 0.8]]])
    gt_masks = (torch.rand(2, 28, 28, 2, generator=torch.Generator().manual_seed(6)) > 0.5).float()
    anchors = torch.from_numpy(get_anchors(cfg, cfg.image_shape))
    out = M.forward_train(model, images, gt_class_ids, gt_boxes, gt_masks, anchors,
                          torch.tensor(cfg.rpn_bbox_std_dev))
    out.class_logits.sum().backward()
    assert features_calls and all(s == images.shape for s in features_calls)
    assert model.backbone.conv1.weight.grad is not None


def test_export_program_runs_model_features(features_calls, monkeypatch):
    det = build_detector(_config(), device="cpu", seed=0)
    _as_if_cuda(monkeypatch)  # even where the step would replay a graph, the export traces the model
    program, sidecar = export_program(det)
    assert features_calls and sidecar["quant_mode"] == "none" and not det._graphed
    assert program.graph_signature.user_inputs


# ----------------------------------------------------------------- card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU version)")
    return torch.device("cuda")


def _cell_detector(seed, device):
    """The bf16 benchmark cell's detector (ResNet-101, 512^2, batch 8,
    bf16, 6000 / 1000 / 100) with the benchmark's seeded weights."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark.drivers.detect_tiles import build_detector as bench_detector
    from benchmark.weights import make_weights

    with open(REPO / "benchmark" / "configs" / "mrcnn-r101-fpn256-512-bf16.json") as f:
        cfg = json.load(f)["config"]
    return bench_detector(cfg, make_weights(cfg, seed, device), device), cfg


def _run(det, batches, eager, monkeypatch):
    """Every batch dispatched with two in flight, then collected:
    (detections, masks, frames) each."""
    with monkeypatch.context() as m:
        if eager:
            m.setattr(D.G, "engages", lambda device, int8_graph: False)
        handles, out = [], []
        for tiles in batches:
            handles.append(det.dispatch_tiles(tiles))
            if len(handles) == 2:
                out.append(det.fetch(handles.pop(0)))
        out += [det.fetch(h) for h in handles]
    return [(d.copy(), m.copy(), [f.clone() for f in frames]) for d, m, _, _, _, frames in out]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gm, gf), (wd, wm, wf) in zip(got, want):
        assert np.array_equal(gd, wd) and np.array_equal(gm, wm)
        assert len(gf) == len(wf) and all(torch.equal(a, b) for a, b in zip(gf, wf))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cell", "small f32"])
def test_graphed_pyramid_equals_eager_features(cuda, case):
    if case == "cell":
        det, _ = _cell_detector(7, cuda)
        shape = (8, 512, 512, 3)
    else:
        det = build_detector(_config(backbone="custom", image_min_dim=128, image_max_dim=128), device=cuda, seed=0)
        shape = (2, 128, 128, 3)
    model = det.model
    rng = np.random.RandomState(8)
    graphed = G.GraphedFeatures(model)
    with torch.inference_mode(), telemetry.recording() as rec:
        for _ in range(3):  # the capture, then two replays on other batches
            images = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(cuda)
            got = [p.clone() for p in graphed.features(images)]
            want = model.features(images)
            torch.cuda.synchronize()
            assert all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    counters = rec.summary()["counters"]
    assert counters["detect.features.graph_captures"] == 1 and counters["detect.features.graph_replays"] == 3


@pytest.mark.cuda
def test_tiled_detector_equals_eager_detector(cuda, monkeypatch):
    det, _ = _cell_detector(1234567891, cuda)
    rng = np.random.RandomState(9)
    batches = [rng.randint(0, 256, (8, 512, 512), np.uint8) for _ in range(3)] + \
              [rng.randint(0, 256, (3, 512, 512), np.uint8)]  # a padded partial batch last
    want = _run(det, batches, True, monkeypatch)
    with telemetry.recording() as rec:
        got = _run(det, batches, False, monkeypatch)
    _assert_same(got, want)
    assert len(got[-1][2]) == 3 and int((got[0][0][:, :, 4] > 0).sum()) > 0
    counters = rec.summary()["counters"]
    assert counters["detect.features.graph_captures"] == 1
    assert counters["detect.features.graph_replays"] == len(batches)


@pytest.mark.cuda
def test_load_state_dict_replays_the_new_weights(cuda, monkeypatch):
    det, _ = _cell_detector(10, cuda)
    rng = np.random.RandomState(11)
    batches = [rng.randint(0, 256, (8, 512, 512), np.uint8) for _ in range(2)]
    with telemetry.recording() as rec:
        first = _run(det, batches, False, monkeypatch)  # captured on the first weights
        other, _ = _cell_detector(12, cuda)
        det.model.load_state_dict(other.model.state_dict())
        del other
        got = _run(det, batches, False, monkeypatch)
    counters = rec.summary()["counters"]
    assert counters["detect.features.graph_captures"] == 1 and counters["detect.features.graph_replays"] == 4
    _assert_same(got, _run(det, batches, True, monkeypatch))
    assert not np.array_equal(got[0][0], first[0][0])


@pytest.mark.cuda
def test_two_replicas_replay_their_own_pyramids(cuda, monkeypatch):
    devices = [torch.device("cuda", i if torch.cuda.device_count() > 1 else 0) for i in range(2)]
    kw = dict(KW, image_min_dim=128, image_max_dim=128)
    one = build_detector(inference_config(detector_config(**kw), images_per_device=4, num_devices=1),
                         device=cuda, seed=0)
    det = D.Detector(inference_config(detector_config(**kw), images_per_device=2, num_devices=2), one.model, devices)
    del one
    rng = np.random.RandomState(15)
    batches = [rng.randint(0, 256, (4, 128, 128), np.uint8) for _ in range(3)]
    pyramids = []  # (device, P2 .. P6) of every features call, copied on its stream
    for cls in (M.MaskRCNN, G.GraphedFeatures):
        def kept(self, images, features=cls.features):
            out = features(self, images)
            pyramids.append((images.device, [p.clone() for p in out]))
            return out
        monkeypatch.setattr(cls, "features", kept)
    want = _run(det, batches, True, monkeypatch)
    eager, pyramids[:] = list(pyramids), []
    with telemetry.recording() as rec:
        got = _run(det, batches, False, monkeypatch)
    _assert_same(got, want)
    assert len(pyramids) == len(eager) == 2 * len(batches)
    for (gd, gp), (wd, wp) in zip(pyramids, eager):
        assert gd == wd and all(g.device == gd and torch.equal(g, w) for g, w in zip(gp, wp))
    assert not torch.equal(pyramids[0][1][0], pyramids[2][1][0])  # each batch its own pyramid
    counters = rec.summary()["counters"]
    assert counters["detect.features.graph_captures"] == 2
    assert counters["detect.features.graph_replays"] == 2 * len(batches)
    for i, dev in enumerate(devices):
        (captured,) = det._graphed[i]._graphs.values()
        assert det._graphed[i].model is det._models[i] and captured.pyramid[0].device == dev


@pytest.mark.cuda
def test_int8_detector_never_replays(cuda):
    det = build_detector(_config(quant_mode="int8", backbone="custom", image_min_dim=128, image_max_dim=128),
                         device=cuda, seed=0)
    with telemetry.recording() as rec:
        for seed in (13, 14):
            det.collect(det.dispatch_tiles(_tiles(seed, side=128)))
    counters = rec.summary()["counters"]
    assert isinstance(det._graph(0), DetectStages) and not det._graphed
    assert not set(COUNTERS) & set(counters) and counters["detect.int8.sites"] > 0
