"""The port's int8 serving graph against the JAX package's, on the CPU, at
``tests/test_quant.py``'s small configuration (custom backbone, 128^2,
batch 2, f32, jittered batch norms), with the same weights:

* folding (``fold_bn``, ``fold_detect``) and ``quantize_conv`` bit for bit
  (the same numpy arithmetic on the same flax tree);
* ``quantize_int8``'s plain version bit for bit against
  ``jnp.clip(jnp.round(x / s), -127, 127)``, on exact .5 ties too;
* ``conv2d_int8``'s plain int32 sums equal to ``lax.conv_general_dilated``
  on int8 with int32 accumulation, for every padding kind and stride the
  graph has. The port's epilogue rounds the product and then the sum (as
  its kernel does). XLA on the CPU, jitting ``acc * sw + b`` alone,
  contracts it into one fused multiply-add: the two differ there by at
  most half an ulp of the product plus an ulp of the result;
* the folded f32 forward and stages within 1e-5 relative L2, and the
  calibration's scales within 1e-5 relative (f32 convolutions summed in
  another order);
* the int8 stages on one shared quantized tree, each stage fed the JAX
  input: the int8 pyramid bit for bit (inside the whole jitted graph XLA
  rounds each epilogue's product before its sum, as the port does, and the
  rest of the backbone and the FPN is exact integer arithmetic and f32
  sums of the same pairs); the RPN, classifier and mask outputs within
  1e-5 relative L2, since their float heads sum in another order;
* the ``Detector``'s automatic calibration, and its int8 detections
  against the JAX ``Detector``'s (isolated detections, as in
  ``tests/test_torch_detector.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.config import inference_config as j_inference_config
from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
from caesar_mrcnn_tpu.models import backbone_int8 as JBQ
from caesar_mrcnn_tpu.models import heads_int8 as JQ
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.models.mask_rcnn import init_model
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.inference.detector import Detector, build_detector
from caesar_mrcnn_tpu_torch.models import backbone_int8 as BQ
from caesar_mrcnn_tpu_torch.models import heads_int8 as Q
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from caesar_mrcnn_tpu_torch.ops import quant as QO
from caesar_mrcnn_tpu_torch.testing import compare_detections, settle_flax_weights
from test_quant import _jitter, _small_cfg

torch.set_num_threads(2)

# the int8 stages' float heads against JAX's (f32 sums in another order)
HEAD_REL_L2 = 1e-5


def _port_config(jcfg):
    return tconfig.Config(**dataclasses.asdict(jcfg))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, model, variables; port model with those weights;
    molded images, metas, anchors) as ``tests/test_quant.py::setup``."""
    jcfg = _small_cfg()
    jmodel, variables = init_model(jcfg, jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.array, _jitter(variables))
    model = MaskRCNN(_port_config(jcfg))
    model.load_state_dict(W.flax_to_state_dict(variables))
    model.eval()
    rs = np.random.RandomState(11)
    h, w, c = jcfg.image_shape
    molded = rs.uniform(0, 255, (jcfg.batch_size, h, w, c)).astype(np.float32)
    from caesar_mrcnn_tpu.models.meta import compose_image_meta
    from caesar_mrcnn_tpu.utils.anchors import get_anchors

    meta = compose_image_meta(0, (h, w, c), (h, w, c), (0, 0, h, w), 1.0, np.zeros(jcfg.num_classes))
    metas = np.tile(meta.astype(np.float32), (jcfg.batch_size, 1))
    anchors = get_anchors(jcfg, (h, w, c))
    return jcfg, jmodel, variables, model, molded, metas, anchors


@pytest.fixture(scope="module")
def calibrated(setup):
    """The JAX package's folded tree, scales and quantized tree."""
    jcfg, jmodel, variables, *_, molded, metas, anchors = setup
    folded = JQ.fold_detect(variables, jcfg)
    scales = JQ.calibrate_detect(jmodel, variables, jcfg, folded, molded, metas, anchors)
    return folded, scales, JQ.quantize_detect(folded, scales)


# ------------------------------------------------------- folding, quantizing


def test_fold_bn_and_fold_detect_equal_jax_bitwise(setup):
    jcfg, _, variables, model, *_ = setup
    tree = W.state_dict_to_flax(model.state_dict())
    got, ref = Q.fold_detect(tree, _port_config(jcfg)), JQ.fold_detect(variables, jcfg)
    assert list(got) == list(ref) and len(got) == 1 + 10 + 13 + 7 + 10 + 8 + 1 + 2 + 4
    for site in ref:
        for g, r in zip(got[site], ref[site]):
            assert g.dtype == r.dtype == np.float32
            np.testing.assert_array_equal(g, r, err_msg=site)
    bare = {k: {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}
            for k, v in (("got", tree), ("ref", variables))}
    got, ref = BQ.fold_bn(bare["got"], "custom"), JBQ.fold_bn(bare["ref"], "custom")
    assert list(got) == list(ref)
    for name in ref:
        for g, r in zip(got[name], ref[name]):
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_quantize_conv_equals_jax_bitwise(setup):
    jcfg, _, variables, *_ = setup
    folded = JQ.fold_detect(variables, jcfg)
    rs = np.random.RandomState(0)
    w0, b0 = folded["mask/conv1"]
    w0 = w0.copy()
    w0[..., 3] = 0.0  # an all-zero filter: the 1e-12 floor of its scale
    cases = list(folded.items()) + [("zero filter", (w0, b0))]
    for site, (w, b) in cases:
        s = np.float32(rs.uniform(1e-3, 2.0))
        got, ref = BQ.quantize_conv(w, b, s), JBQ.quantize_conv(w, b, s)
        assert sorted(got) == sorted(ref) == ["b", "s_in", "sw", "w"]
        for k in ref:
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, (site, k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{site} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_plain_equals_jnp_on_ties(dtype):
    """Exact .5 ties (a power-of-two scale, so x / s is exact), values past
    +-127, and seeded values at a scale that is not a power of two; the
    scale a traced argument, as the JAX graph passes it."""
    rs = np.random.RandomState(1)
    ties = (np.arange(-140, 140) + 0.5).astype(np.float32)
    jq = jax.jit(lambda x, s: jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127, 127).astype(jnp.int8))
    for x, s in ((ties * np.float32(0.25), 0.25), (ties * np.float32(2.0), 2.0),
                 (rs.uniform(-9, 9, 5000).astype(np.float32), 0.0371)):
        xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
        got = QO.quantize_int8(xt, s)
        ref = np.asarray(jq(xj, np.float32(s)))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), ref)
    assert int(QO.quantize_int8(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]), 1.0).abs().sum()) == 0 + 2 + 2 + 0 + 2


CONV_CASES = {
    # name: (B, H, W, Cin, Cout, k, stride, padding)
    "stem explicit 3, 7x7/2": (2, 33, 30, 3, 8, 7, 2, QO.STEM_PADS),
    "SAME 1x1/1": (2, 9, 7, 16, 12, 1, 1, "SAME"),
    "SAME 1x1/2": (2, 10, 9, 32, 8, 1, 2, "SAME"),
    "SAME 3x3/1": (2, 9, 8, 16, 24, 3, 1, "SAME"),
    "SAME 3x3/2 odd": (1, 11, 9, 16, 8, 3, 2, "SAME"),
    "VALID 7x7": (5, 7, 7, 32, 16, 7, 1, "VALID"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_int8_plain_equals_lax(case):
    b, h, w, cin, cout, k, stride, padding = CONV_CASES[case]
    rs = np.random.RandomState(len(case))
    x = rs.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rs.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)  # HWIO
    sw = rs.uniform(1e-6, 1e-3, cout).astype(np.float32)
    bias = rs.uniform(-1, 1, cout).astype(np.float32)
    pads = QO.xla_pads(padding, k, stride, (h, w))
    jpad = padding if isinstance(padding, str) else [tuple(p) for p in padding]
    ref_acc = np.asarray(jax.lax.conv_general_dilated(
        x, wq, (stride, stride), jpad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    packed = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
    got_acc = QO.conv2d_int8_accumulate(torch.from_numpy(x), packed, stride, pads)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), ref_acc)

    got = QO.conv2d_int8(torch.from_numpy(x), packed, torch.from_numpy(sw), torch.from_numpy(bias), stride, pads)
    ref = np.asarray(jax.jit(lambda a, s, c: a.astype(jnp.float32) * s + c)(ref_acc, sw, bias))
    prod = ref_acc.astype(np.float32) * sw
    np.testing.assert_array_equal(got.numpy(), prod + bias)  # the product rounded, then the sum
    assert (np.abs(got.numpy() - ref) <= np.spacing(np.abs(prod)) / 2 + np.spacing(np.abs(ref))).all()
    relu = QO.conv2d_int8(torch.from_numpy(x), packed, torch.from_numpy(sw), torch.from_numpy(bias), stride, pads,
                          relu=True)
    np.testing.assert_array_equal(relu.numpy(), np.maximum(prod + bias, 0))


# ---------------------------------------------------------- folded graph


def test_folded_forward_and_stages_equal_jax(setup, calibrated):
    jcfg, jmodel, variables, model, molded, *_ = setup
    folded = calibrated[0]
    bare = {"params": variables["params"]["backbone"], "batch_stats": variables["batch_stats"]["backbone"]}
    bb = JBQ.fold_bn(bare, "custom")
    ref = JBQ.folded_forward(bb, jnp.asarray(molded), "custom")
    with torch.inference_mode():
        got = BQ.folded_forward(bb, torch.from_numpy(molded), "custom")
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel_l2(_np(g), r) < 1e-5

    vars_f = dict(variables, folded=folded)
    jst = JQ.folded_stages(jcfg)
    tst = Q.folded_stages(model, folded)
    pyr_ref = jst["features"](vars_f, jnp.asarray(molded))
    with torch.inference_mode():
        pyr = tst.features(torch.from_numpy(molded))
        for p, r in zip(pyr, pyr_ref):
            assert _rel_l2(_np(p.permute(0, 2, 3, 1)), r) < 1e-5
        rpn = tst.rpn([torch.from_numpy(np.array(r)).permute(0, 3, 1, 2) for r in pyr_ref])
    for g, r in zip(rpn, jst["rpn"](vars_f, pyr_ref)):
        assert _rel_l2(_np(g), r) < 1e-5
    rs = np.random.RandomState(5)
    for name, pool in (("classifier", jcfg.pool_size), ("mask", jcfg.mask_pool_size)):
        pooled = rs.normal(0, 1, (jcfg.batch_size, 8, pool, pool, jcfg.top_down_pyramid_size)).astype(np.float32)
        ref = jst[name](vars_f, jnp.asarray(pooled))
        with torch.inference_mode():
            got = getattr(tst, name)(torch.from_numpy(pooled))
        for g, r in zip(got if name == "classifier" else [got], ref if name == "classifier" else [ref]):
            assert g.shape == r.shape and _rel_l2(_np(g), r) < 1e-5, name


def test_backbone_int8_pipeline_equals_jax(setup):
    """The backbone-only pipeline (``build_qtree``: fold, ``calibrate``,
    ``quantize``; then ``resnet_int8``) against the JAX package's: scales
    within 1e-5 relative (f32 sums in another order), int8 weights equal,
    and on one quantized tree (the JAX package's) C2..C5 bit for bit
    (JAX runs ``resnet_int8`` op by op, rounding each product before its
    sum, as the port does)."""
    _, _, variables, _, molded, *_ = setup
    bare = {"params": variables["params"]["backbone"], "batch_stats": variables["batch_stats"]["backbone"]}
    got, ref = BQ.build_qtree(bare, "custom", molded, device="cpu"), JBQ.build_qtree(bare, "custom", molded)
    assert sorted(got) == sorted(ref) and len(ref) == 1 + 10 + 13 + 7 + 10
    for name in ref:
        np.testing.assert_array_equal(got[name]["w"], ref[name]["w"], err_msg=name)
        assert float(got[name]["s_in"]) == pytest.approx(float(ref[name]["s_in"]), rel=1e-5), name
    out = JBQ.resnet_int8(ref, jnp.asarray(molded), "custom", out_dtype=jnp.float32)
    with torch.inference_mode():
        port = BQ.resnet_int8(ref, torch.from_numpy(molded), "custom", out_dtype=torch.float32)
    for g, r in zip(port, out):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_calibrate_detect_equals_jax(setup, calibrated):
    """Every quantized site calibrated, the RPN's per level, each scale
    within 1e-5 relative of the JAX package's."""
    _, _, _, model, molded, metas, anchors = setup
    folded, ref, _ = calibrated
    got = Q.calibrate_detect(model, folded, molded, metas, anchors)
    assert sorted(got) == sorted(ref)
    assert {f"rpn/shared@{lvl}" for lvl in Q.LEVELS} <= set(got)
    assert set(got) == (set(folded) - {"rpn/shared"}) | {f"rpn/shared@{lvl}" for lvl in Q.LEVELS}
    for site in ref:
        assert got[site] == pytest.approx(ref[site], rel=1e-5), site


# ------------------------------------------------------------- int8 graph


def test_int8_stages_equal_jax_on_one_qtree(setup, calibrated):
    """The JAX package's quantized tree through ``weights.qtree_to_torch``
    into both packages' int8 stages, each stage fed the JAX input."""
    jcfg, _, variables, model, molded, *_ = setup
    _, scales, qtree = calibrated
    packed = W.qtree_to_torch(qtree)
    q = qtree["rpn/shared@p3"]
    assert packed["rpn/shared@p3"]["w"].shape == (q["w"].shape[3], 3, 3, q["w"].shape[2])
    assert packed["rpn/shared@p3"]["s_in"] == float(q["s_in"])
    vars_q = dict(variables, quant=qtree)
    jst = JQ.int8_stages(jcfg)
    tst = Q.int8_stages(model, qtree)
    assert len(tst.convs.sites) == len(qtree) == 1 + 10 + 13 + 7 + 10 + 8 + 5 + 2 + 4

    pyr_ref = jst["features"](vars_q, jnp.asarray(molded))
    with torch.inference_mode():
        pyr = tst.features(torch.from_numpy(molded))
        for p, r in zip(pyr, pyr_ref):
            assert p.is_contiguous(memory_format=torch.channels_last)
            np.testing.assert_array_equal(_np(p.permute(0, 2, 3, 1)), np.asarray(r))
        rpn = tst.rpn([torch.from_numpy(np.array(r)).permute(0, 3, 1, 2) for r in pyr_ref])
    rpn_ref = jst["rpn"](vars_q, pyr_ref)
    for g, r in zip(rpn, rpn_ref):  # logits, probabilities, deltas
        assert _rel_l2(_np(g), r) < HEAD_REL_L2
    rs = np.random.RandomState(5)
    for name, pool in (("classifier", jcfg.pool_size), ("mask", jcfg.mask_pool_size)):
        s = scales[f"{'cls' if name == 'classifier' else 'mask'}/conv1"] * 127.0
        pooled = (s * 0.5 * rs.uniform(-1, 1, (jcfg.batch_size, 8, pool, pool, jcfg.top_down_pyramid_size))
                  ).astype(np.float32)
        ref = jst[name](vars_q, jnp.asarray(pooled))
        with torch.inference_mode():
            got = getattr(tst, name)(torch.from_numpy(pooled))
        for g, r in zip(got if name == "classifier" else [got], ref if name == "classifier" else [ref]):
            assert g.shape == r.shape and _rel_l2(_np(g), r) < HEAD_REL_L2, name


def test_int8_stages_track_the_folded_graph(setup, calibrated):
    """``tests/test_quant.py``'s bound on the port alone: the int8 pyramid
    within 0.25 relative L2 of the folded f32 graph's."""
    _, _, _, model, molded, *_ = setup
    folded, _, qtree = calibrated
    with torch.inference_mode():
        pf = Q.folded_stages(model, folded).features(torch.from_numpy(molded))
        pq = Q.int8_stages(model, qtree).features(torch.from_numpy(molded))
    for f, q in zip(pf, pq):
        assert 0 < _rel_l2(_np(q), _np(f)) < 0.25


# --------------------------------------------------------------- Detector


def _jax_detector_weights(seed=13):
    jcfg = j_inference_config(_small_cfg(quant_mode="int8"))
    jmodel, variables = init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jmodel, jax.tree_util.tree_map(np.array, _jitter(variables, seed=seed))


def test_detector_autoquant_detect_and_tiles():
    """``tests/test_quant.py::test_detector_autoquant_detect_and_tiles`` on
    the port: the first ``detect`` calibrates and swaps the graph, the next
    reuses it, the tile path runs on it, and new weights drop it (the next
    batch calibrates again)."""
    jcfg, _, tree = _jax_detector_weights()
    det = build_detector(_port_config(jcfg), device="cpu", weights=tree)
    assert det._stages is None and det.qtree is None
    rs = np.random.RandomState(2)
    img = rs.uniform(0, 255, (132, 132, 3)).astype(np.float32)
    r = det.detect([img])[0]
    assert det._stages is not None, "auto-quantization did not trigger"
    assert det.qtree["bb/conv1"]["w"].dtype == np.int8 and len(det.qtree) == 60
    n = len(r["class_ids"])
    assert r["rois"].shape == (n, 4) and r["masks"].shape[:2] == img.shape[:2]

    stages = det._stages
    det.detect([img])
    assert det._stages is stages  # no recalibration

    h, w, _ = jcfg.image_shape
    out = det.detect_tiles(rs.uniform(0, 255, (1, h, w)).astype(np.uint8))
    assert len(out) == 1 and "rois" in out[0] and det._stages is stages

    det.model.load_state_dict(det.model.state_dict())  # new weights (the same values)
    det.detect([img])
    assert det._stages is not None and det._stages is not stages  # calibrated again

    plain = build_detector(_port_config(jcfg).replace(quant_mode="none"), device="cpu", weights=tree)
    plain.quantize([img])
    assert plain._stages is not None
    with torch.no_grad():
        plain.model.backbone.conv1.weight.mul_(0.5)
    plain.detect([img])
    assert plain._stages is None  # the exact graph again, as the JAX setter does


def test_detector_int8_matches_jax_detector():
    """Both detectors calibrate on the same tile batch and detect on it;
    settled weights, so that detections exist. The two calibrations sum
    their f32 convolutions in another order, so some scales differ in the
    last bits (within 1e-5 relative; 9e-7 seen) and move a few quantized
    values by one step: one detection's score moved by more than 5e-5
    here. So detections are compared where isolated by 2e-3 (6 of 16),
    scores and boxes (normalized) within 1e-4 (1.2e-7 seen)."""
    jcfg, jmodel, tree = _jax_detector_weights()
    tree = settle_flax_weights(tree)
    jdet = JaxDetector(jcfg, jmodel, tree)
    tdet = build_detector(_port_config(jcfg), device="cpu", weights=tree)
    h, w, _ = jcfg.image_shape
    tiles = np.random.RandomState(3).randint(0, 255, (1, h, w), np.uint8)
    got_f = tdet.fetch(tdet.dispatch_tiles(tiles))
    ref_f = jdet.fetch(jdet.dispatch_tiles(tiles))
    assert tdet.qtree is not None and jdet._stages is not None
    for site, q in jdet.variables["quant"].items():
        assert float(tdet.qtree[site]["s_in"]) == pytest.approx(float(q["s_in"]), rel=1e-5), site

    def raw(f):
        d = f[0][0]
        d = d[d[:, 4] > 0]
        return {"boxes": d[:, :4], "class_ids": d[:, 4], "scores": d[:, 5]}

    cmp = compare_detections(raw(ref_f), raw(got_f), gap=2e-3)
    assert cmp["compared"] >= 4 and cmp["unmatched"] == 0 and cmp["class_mismatch"] == 0, cmp
    assert cmp["max_scores_diff"] <= 1e-4 and cmp["max_boxes_diff"] <= 1e-4, cmp


# ------------------------------------------------------ what the port refuses


def test_detector_refuses_unknown_quant_mode_and_roi_gather_dtype():
    cfg = tconfig.detector_config(backbone="custom", image_min_dim=64, image_max_dim=64, compute_dtype="float32")
    with pytest.raises(ValueError, match="quant_mode"):
        build_detector(cfg.replace(quant_mode="fp8"), device="cpu")
    with pytest.raises(NotImplementedError, match="Not to port"):
        build_detector(cfg.replace(roi_gather_dtype="float8_e4m3fn"), device="cpu")
    with pytest.raises(NotImplementedError, match="roi_gather_dtype"):
        Detector(cfg.replace(roi_gather_dtype="float8_e4m3fn", quant_mode="int8"), MaskRCNN(cfg), "cpu")
