"""Frozen batch norms folded into their convolutions on the inference path
(``caesar_mrcnn_tpu_torch/ops/fold.py``, ``models/layers.py::folds`` and
``fold``, ``models/backbone.py``, ``models/heads.py::MaskHead``).

On the CPU, with seeded weights whose biases and batch norms are all off
their defaults (``_seed_affine``), in f32, the modules in eval mode (as
``Detector`` sets its model):

* ``fold_conv_bn_plain`` (the CPU operator, the card kernel's oracle)
  equals the formula in numpy's f32 bit for bit, ``inv = scale / sqrt(var
  + eps)``,
  ``w' = w * inv`` laid out OHWI, ``b' = (bias - mean) * inv + shift``,
  each in f32 then cast, to f32 and to bf16; the wrapper's views are
  channels_last and lie end to end in the two flat outputs, which they
  cover;
* the folded stem, a bottleneck without and with a projection shortcut,
  the whole custom ResNet and the mask head equal the unfolded chain (the
  same modules with gradients on) within ``F32_TOL`` of the reference's
  largest magnitude: the same arithmetic in another order (read: up to
  ~5e-7 here);
* the rule: with gradients on, or inside ``batch_statistics``, or with the
  model in train mode (a training run's validation pass), or with a
  forward hook on any of the ResNet's modules, nothing folds (the counter
  ``model.conv_bn_folded`` stays 0); with gradients on, the scales, shifts
  and weights get bit for bit the gradients of the chain written out by
  hand, and in train mode the output is the training forward's bit for
  bit;
* the counter: a float CPU detector's batch folds the custom backbone's 41
  pairs and the mask head's 4; an int8 detector's batch, calibration
  included, folds none.

On the card (marker ``cuda``, skipped here): the kernel against the plain
version on the bf16 cell's own ResNet-101 and mask-head pairs, to bf16 and
f32, bit for bit; the folded bf16 pyramid at the cell's shape (batch 8,
512^2) as close to the unfolded f32 pyramid as the unfolded bf16 one,
within a factor ``CELL_PYRAMID_TOL``; a profiled
replay of the features graph with one fold launch, no batch-norm kernel
and no ATen broadcast add but the FPN's eight conv biases; the counter at
a capture and at a batch. There, without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_fold_bn.py
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caesar_mrcnn_tpu_torch import telemetry
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.inference.detector import build_detector
from caesar_mrcnn_tpu_torch.models import layers
from caesar_mrcnn_tpu_torch.models.backbone import Bottleneck, ResNet
from caesar_mrcnn_tpu_torch.models.heads import MaskHead
from caesar_mrcnn_tpu_torch.ops import fold as Fo

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5  # folded against unfolded, over the reference's largest magnitude
COUNTER = "model.conv_bn_folded"
KW = dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
          class_names=("bkg", "sidelobe", "source", "galaxy"), rpn_anchor_scales=(8, 16, 32, 64, 128),
          pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=8, compute_dtype="float32")


def _seed_affine(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """LeCun-scaled conv weights, biases at 0.01 n, and every batch norm
    near the identity but off it (scale 1 + 0.1 n, shift and mean 0.05 n,
    variance exp(0.1 n)), as the benchmark's weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.FrozenBatchNorm):
                c = m.scale.shape[0]
                m.scale.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.05 * torch.randn(c, generator=g))
                m.mean.copy_(0.05 * torch.randn(c, generator=g))
                m.var.copy_((0.1 * torch.randn(c, generator=g)).exp())
            elif isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * m.weight[0].numel() ** -0.5)
                m.bias.copy_(0.01 * torch.randn(m.bias.shape, generator=g))
    return module


def _input(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)


def _pairs_args(pairs):
    convs, bns = zip(*pairs)
    return ([c.weight.detach() for c in convs], [c.bias.detach() for c in convs],
            [b.scale.detach() for b in bns], [b.bias.detach() for b in bns], [b.mean for b in bns],
            [b.var for b in bns])


# ------------------------------------------------------------------ the fold


def _random_pairs(rng, shapes):
    w = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for s in shapes]
    vec = [[torch.from_numpy(rng.uniform(lo, hi, s[0]).astype(np.float32)) for s in shapes]
           for lo, hi in ((-0.1, 0.1), (0.8, 1.2), (-0.1, 0.1), (-0.1, 0.1), (0.5, 2.0))]
    return w, vec


SHAPES = [(64, 3, 7, 7), (24, 16, 1, 1), (24, 8, 3, 3), (24, 12, 1, 1), (5, 3, 3, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_plain_equals_the_formula(dtype):
    w, (bias, scale, shift, mean, var) = _random_pairs(np.random.RandomState(0), SHAPES)
    flat_w, flat_b = Fo.fold_conv_bn_plain(w, bias, scale, shift, mean, var, 1e-3, dtype)
    w_off, b_off, nw, nb = Fo.fold_layout(SHAPES)
    assert flat_w.dtype == flat_b.dtype == dtype and flat_w.shape == (nw,) and flat_b.shape == (nb,)
    eps = np.float32(1e-3)
    n = [[t.numpy() for t in v] for v in (w, bias, scale, shift, mean, var)]

    for j, s in enumerate(SHAPES):  # numpy f32, each operation correctly rounded
        inv = n[2][j] / np.sqrt(n[5][j] + eps)
        b = (n[1][j] - n[4][j]) * inv + n[3][j]
        want_w = torch.from_numpy((n[0][j] * inv[:, None, None, None]).transpose(0, 2, 3, 1).reshape(-1))
        assert torch.equal(flat_w[w_off[j]:w_off[j] + w[j].numel()], want_w.to(dtype))
        assert torch.equal(flat_b[b_off[j]:b_off[j] + s[0]], torch.from_numpy(b).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_views_are_channels_last_and_end_to_end(dtype):
    w, vec = _random_pairs(np.random.RandomState(1), SHAPES)
    out = Fo.fold_conv_bn(w, *vec, 1e-3, dtype)
    flat_w, flat_b = Fo.fold_conv_bn_plain(w, *vec, 1e-3, dtype)
    w_off, b_off, nw, nb = Fo.fold_layout(SHAPES)
    assert (nw, nb) == (sum(np.prod(s) for s in SHAPES), sum(s[0] for s in SHAPES))
    for j, (wf, bf) in enumerate(out):
        assert wf.shape == SHAPES[j] and bf.shape == (SHAPES[j][0],) and wf.dtype == bf.dtype == dtype
        assert wf.is_contiguous(memory_format=torch.channels_last)
        assert w_off[j] == sum(np.prod(s) for s in SHAPES[:j]) and b_off[j] == sum(s[0] for s in SHAPES[:j])
        assert torch.equal(wf.permute(0, 2, 3, 1).reshape(-1), flat_w[w_off[j]:w_off[j] + wf.numel()])
        assert torch.equal(bf, flat_b[b_off[j]:b_off[j] + bf.numel()])


def test_fold_refuses_mismatched_tables():
    w, vec = _random_pairs(np.random.RandomState(2), SHAPES[:2])
    with pytest.raises(ValueError, match="vectors of 64 channels"):
        Fo.fold_conv_bn(w, vec[0][::-1], *vec[1:], 1e-3, torch.float32)  # 24 channels against 64
    with pytest.raises(ValueError, match="one bias"):
        Fo.fold_conv_bn(w, vec[0][:1], *vec[1:], 1e-3, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        Fo.fold_conv_bn(w, *vec, 1e-3, torch.float16)
    many = Fo.MAX_PAIRS + 1  # one launch's table
    with pytest.raises(ValueError, match=f"1 to {Fo.MAX_PAIRS}"):
        Fo.fold_conv_bn(w[:1] * many, *(v[:1] * many for v in vec), 1e-3, torch.float32)


# ------------------------------------------------- folded against unfolded


def _close(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert ((g - w).abs().max() / w.abs().max()).item() <= F32_TOL


def _stem(m: ResNet, x):
    if layers.folds([(m.conv1, m.bn_conv1)]):
        (w, b), = layers.fold([(m.conv1, m.bn_conv1)], x.dtype)
        return Fo.conv_bias_relu(x, w, b, stride=2, padding=3)
    return F.relu(m.bn_conv1(m.conv1(x)))


def _block(m: Bottleneck, x):
    """A bottleneck as the ResNet runs it: on its folded pairs where
    ``layers.folds`` allows."""
    pairs = m.conv_bn_pairs()
    return m(x, layers.fold(pairs, x.dtype) if layers.folds(pairs) else None)


PARTS = {
    "stem": (lambda: ResNet("custom"), _stem, (2, 3, 32, 32), 1),
    "bottleneck": (lambda: Bottleneck(64, (16, 16, 64)), _block, (2, 64, 16, 16), 3),
    "bottleneck with projection": (lambda: Bottleneck(32, (16, 16, 64), stride=2, project=True), _block,
                                   (2, 32, 16, 16), 4),
    "resnet": (lambda: ResNet("custom"), None, (2, 3, 64, 64), 41),
    "mask head": (lambda: MaskHead(4, in_channels=32), None, (6, 14, 14, 32), 4),
}


@pytest.mark.parametrize("part", list(PARTS))
def test_folded_equals_the_unfolded_chain(part):
    make, call, shape, pairs = PARTS[part]
    m = _seed_affine(make(), 3).eval()
    call = call or (lambda m, x: m(x))
    x = _input(shape, 4)
    if part == "mask head":
        x = x.contiguous()  # pooled ROIs arrive NHWC
    with torch.no_grad(), telemetry.recording() as rec:
        got = call(m, x)
    assert rec.summary()["counters"].get(COUNTER) == pairs
    with telemetry.recording() as rec:
        want = call(m, x)
    assert COUNTER not in rec.summary()["counters"]
    _close(got, tuple(t.detach() for t in want) if isinstance(want, tuple) else want.detach())


def _chain_by_hand(block: Bottleneck, x):
    """The unfolded bottleneck written out (conv with bias, batch norm in
    inference mode, add, ReLU), as the port ran it before the fold."""
    def cbn(conv, bn, y):
        y = F.conv2d(y, conv.weight, conv.bias, conv.stride, conv.padding)
        return F.batch_norm(y, bn.mean, bn.var, bn.scale, bn.bias, training=False, eps=layers.BN_EPS)

    y = F.relu(cbn(block.conv1, block.bn1, x))
    y = F.relu(cbn(block.conv2, block.bn2, y))
    y = cbn(block.conv3, block.bn3, y)
    return F.relu(y + (x if block.shortcut is None else cbn(block.shortcut, block.shortcut_bn, x)))


@pytest.mark.parametrize("project", [False, True])
def test_with_gradients_nothing_folds_and_the_gradients_hold(project):
    block = _seed_affine(Bottleneck(32 if project else 64, (16, 16, 64), project=project), 5).eval()
    x = _input((2, 32 if project else 64, 8, 8), 6)
    grads = []
    for fn in (lambda y: _block(block, y), lambda y: _chain_by_hand(block, y)):
        block.zero_grad()
        with telemetry.recording() as rec:
            (fn(x) * _input((2, 64, 8, 8), 7)).sum().backward()
        assert COUNTER not in rec.summary()["counters"]
        grads.append({n: p.grad.clone() for n, p in block.named_parameters()})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) == (16 if project else 12)
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_inside_batch_statistics_nothing_folds():
    block = _seed_affine(Bottleneck(64, (16, 16, 64), bn=layers.BatchNorm), 8).eval()
    x = _input((2, 64, 8, 8), 9)
    with torch.no_grad(), telemetry.recording() as rec:
        with layers.batch_statistics(block) as stats:
            got = _block(block, x)
        frozen = _block(block, x)  # outside the block the trainable batch norm is frozen: it folds
    assert rec.summary()["counters"][COUNTER] == 3 and len(stats) == 3
    with torch.enable_grad(), layers.batch_statistics(block):
        want = block(x).detach()
    assert torch.equal(got, want)
    _close(frozen, block(x).detach())


def test_a_hooked_module_keeps_its_pair_unfolded():
    m = _seed_affine(ResNet("custom"), 10).eval()
    seen = []
    handle = m.res3b.conv2.register_forward_hook(lambda mod, args, out: seen.append(out.shape))
    x = _input((2, 3, 64, 64), 11)
    with torch.no_grad(), telemetry.recording() as rec:
        got = m(x)
    handle.remove()
    # the ResNet folds its whole table or none of it
    assert seen == [(2, 32, 8, 8)] and COUNTER not in rec.summary()["counters"]
    _close(got, tuple(t.detach() for t in m(x)))


def test_train_mode_keeps_the_unfolded_chain():
    """A training run's validation pass: gradients off, the model in train
    mode. It computes what the training forward computes, bit for bit."""
    m = _seed_affine(ResNet("custom"), 14)
    x = _input((2, 3, 64, 64), 15)
    with torch.no_grad(), telemetry.recording() as rec:
        got = m(x)
    assert m.training and COUNTER not in rec.summary()["counters"]
    for g, w in zip(got, m(x)):
        assert torch.equal(g, w.detach())


def _config(**overrides):
    return inference_config(detector_config(**dict(KW, **overrides)), images_per_device=2, num_devices=1)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_a_detect_batch_counts_its_folded_pairs(quant):
    det = build_detector(_config(quant_mode=quant), device="cpu", seed=0)
    tiles = np.random.RandomState(12).randint(0, 255, (2, 64, 64), np.uint8)
    with telemetry.recording() as rec:
        det.collect(det.dispatch_tiles(tiles))  # an int8 detector calibrates on this batch
    counters = rec.summary()["counters"]
    if quant == "none":
        assert counters[COUNTER] == 41 + 4 and "launches.fold_conv_bn" not in counters  # plain on the CPU
    else:
        assert det.int8_graph() is not None and COUNTER not in counters


# ----------------------------------------------------------------- card

CELL_PYRAMID_TOL = 1.25  # a level's bf16 error, folded over unfolded, against the f32 pyramid


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the fold kernel, cuDNN's fused epilogue)")
    return torch.device("cuda")


def _cell_detector(seed, device):
    """The bf16 benchmark cell's detector with the benchmark's seeded
    weights."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark.drivers.detect_tiles import build_detector as bench_detector
    from benchmark.weights import make_weights

    with open(REPO / "benchmark" / "configs" / "mrcnn-r101-fpn256-512-bf16.json") as f:
        cfg = json.load(f)["config"]
    return bench_detector(cfg, make_weights(cfg, seed, device), device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("part", ["backbone", "mask head"])
def test_fold_kernel_equals_plain_on_the_cell_weights(cuda, part, dtype):
    model = _cell_detector(2718281828, cuda).model
    m = model.backbone if part == "backbone" else model.mask_head
    args = _pairs_args(m.conv_bn_pairs())
    before = Fo.fold_conv_bn.launches
    with torch.no_grad():
        got = Fo.fold_conv_bn(*args, layers.BN_EPS, dtype)
    torch.cuda.synchronize()
    assert Fo.fold_conv_bn.launches == before + 1 and len(got) == (104 if part == "backbone" else 4)
    cpu = [[t.cpu() for t in a] for a in args]
    want = Fo.fold_conv_bn(*cpu, layers.BN_EPS, dtype)
    for (gw, gb), (ww, wb) in zip(got, want):
        assert gw.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(gw.cpu(), ww) and torch.equal(gb.cpu(), wb)


@pytest.mark.cuda
def test_folded_cell_pyramid_as_precise_as_unfolded(cuda):
    """Each level's relative L2 distance from the unfolded f32 pyramid (TF32
    off): the folded bf16 pyramid's at most ``CELL_PYRAMID_TOL`` times the
    unfolded bf16 pyramid's."""
    model = _cell_detector(3141592653, cuda).model
    x = torch.from_numpy(np.random.RandomState(13).uniform(0, 255, (8, 512, 512, 3)).astype(np.float32)).to(cuda)
    for p in model.parameters():
        p.requires_grad_(False)
    with torch.no_grad():
        folded = model.features(x)
    with torch.enable_grad():  # no parameter takes a gradient: the unfolded chain, no autograd graph
        unfolded = model.features(x)
        model.dtype = torch.float32
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            exact = model.features(x)
    for f, u, e in zip(folded, unfolded, exact):
        assert f.dtype == u.dtype == torch.bfloat16 and e.dtype == torch.float32
        err = [((t.float() - e).norm() / e.norm()).item() for t in (f, u)]
        print("pyramid level error, folded / unfolded bf16:", err)
        assert err[0] <= CELL_PYRAMID_TOL * err[1], err


@pytest.mark.cuda
def test_replay_runs_no_batch_norm_and_only_the_fpn_bias_adds(cuda):
    from torch.profiler import ProfilerActivity, profile

    from caesar_mrcnn_tpu_torch.inference import graphed as G

    det = _cell_detector(1618033988, cuda)
    graphed = G.GraphedFeatures(det.model)
    x = torch.from_numpy(np.random.RandomState(14).uniform(0, 255, (8, 512, 512, 3)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        graphed.features(x)  # the capture
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graphed.features(x)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not [n for n in names if "batch_norm" in n]
    # the FPN's eight convolutions keep their bias as a broadcast add
    assert len([n for n in names if "elementwise_kernel<128, 4" in n and "add" in n.lower()]) == 8
    assert len([n for n in names if "fold_conv_bn_kernel" in n]) == 1


@pytest.mark.cuda
def test_counter_at_a_capture_and_a_batch(cuda):
    det = _cell_detector(1414213562, cuda)
    tiles = np.random.RandomState(15).randint(0, 256, (8, 512, 512), np.uint8)
    counts = []
    for _ in range(2):
        with telemetry.recording() as rec:
            det.collect(det.dispatch_tiles(tiles))
        counts.append(rec.summary()["counters"][COUNTER])
    # the capture's warm-up pass and the captured pass fold the backbone's
    # 104 pairs each, the mask head its 4; a replay folds without Python
    assert counts == [2 * 104 + 4, 4]
