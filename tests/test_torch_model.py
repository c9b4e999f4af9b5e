"""The port's model stages against the JAX package at f32, one stage at a
time: each torch stage is fed the JAX output of the stage before it, with
the same weights (a seeded flax variable tree, through
``caesar_mrcnn_tpu_torch.weights``). Tolerances: rtol and atol 1e-4 on
stage outputs (f32 convolutions summed in another order), 1e-5 on box math.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.models import backbone as jbackbone
from caesar_mrcnn_tpu.models.detection import refine_detections as jax_refine
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.models.proposals import generate_proposals as jax_proposals
from caesar_mrcnn_tpu.utils import boxes as jboxes
from caesar_mrcnn_tpu.utils import image as jimage
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.config import detector_config, inference_config
from caesar_mrcnn_tpu_torch.models.backbone import ResNet
from caesar_mrcnn_tpu_torch.models.detection import refine_detections
from caesar_mrcnn_tpu_torch.models.layers import FrozenBatchNorm
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from caesar_mrcnn_tpu_torch.models.proposals import generate_proposals
from caesar_mrcnn_tpu_torch.utils import boxes as tboxes
from caesar_mrcnn_tpu_torch.utils import image as timage
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(
    backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
    class_names=("bkg", "sidelobe", "source", "galaxy"), images_per_device=2,
    pre_nms_limit=256, post_nms_rois_inference=64, detection_max_instances=16,
    compute_dtype="float32",
)
# the same configuration for the port and, field by field, for the JAX package
CFG = inference_config(detector_config(**KW), images_per_device=2)
JCFG = jconfig.inference_config(jconfig.detector_config(**KW), images_per_device=2)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.array, variables)


def _random_variables(module, *args, seed):
    """A seeded random flax variable tree for ``module``: fan-in scaled
    kernels, nonzero biases and non-identity frozen batch norm statistics
    (so folding is tested). Only traced, never compiled."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])), shape).astype(np.float32)
        low, high = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(name, (-0.1, 0.1))
        return rng.uniform(low, high, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(jmodel, method, *args):
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=method))(*args)


@pytest.fixture(scope="module")
def models():
    """(JAX module, numpy variables, port model) with the same weights."""
    jmodel = JaxMaskRCNN(JCFG)
    tree = _random_variables(jmodel, np.zeros((1,) + CFG.image_shape, np.float32), seed=0)
    tmodel = MaskRCNN(CFG)
    tmodel.load_state_dict(W.flax_to_state_dict(tree))
    return jmodel, tree, tmodel.eval()


@pytest.fixture(scope="module")
def stages(models):
    """JAX outputs of every stage on one seeded batch."""
    jmodel, tree, _ = models
    rng = np.random.RandomState(1)
    images = rng.uniform(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    pyramid = _apply(jmodel, JaxMaskRCNN.features, tree, images)
    _, probs, bbox = _apply(jmodel, JaxMaskRCNN.rpn, tree, pyramid)
    anchors = get_anchors(CFG, CFG.image_shape)
    proposals, valid = jax_proposals(
        probs, bbox, anchors, jnp.asarray(CFG.rpn_bbox_std_dev, jnp.float32),
        proposal_count=CFG.post_nms_rois_inference, nms_threshold=CFG.rpn_nms_threshold,
        pre_nms_limit=CFG.pre_nms_limit,
    )
    np_ = lambda t: np.array(t)  # noqa: E731
    return {
        "images": images, "pyramid": [np_(p) for p in pyramid], "rpn_probs": np_(probs),
        "rpn_bbox": np_(bbox), "anchors": anchors, "proposals": np_(proposals),
        "valid": np_(valid),
    }


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_converter_layouts_and_deconv_flip():
    """HWIO -> OIHW, Dense (in, out) -> (out, in), frozen batch norm, and
    the ConvTranspose kernel flipped in both spatial axes."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    deconv = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    v = _np_tree(deconv.init(jax.random.PRNGKey(3), x))
    v["params"]["bias"] = rng.randn(4).astype(np.float32)
    ref = np.asarray(deconv.apply(v, x))
    sd = W.flax_to_state_dict({"params": {"mrcnn_mask_deconv": v["params"]}})
    w, b = sd["mrcnn_mask_deconv.weight"], sd["mrcnn_mask_deconv.bias"]
    assert w.shape == (3, 4, 2, 2)
    got = F.conv_transpose2d(_nchw(x), w, b, stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    unflipped = F.conv_transpose2d(_nchw(x), w.flip(2, 3), b, stride=2).permute(0, 2, 3, 1)
    assert np.abs(unflipped.numpy() - ref).max() > 1e-2

    conv = rng.randn(3, 3, 5, 7).astype(np.float32)
    dense = rng.randn(5, 7).astype(np.float32)
    bn = {"BatchNorm_0": {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32),
                          "bias": rng.randn(7).astype(np.float32)}}
    stats = {"BatchNorm_0": {"mean": rng.randn(7).astype(np.float32),
                             "var": rng.uniform(0.5, 2.0, 7).astype(np.float32)}}
    sd = W.flax_to_state_dict({"params": {"c": {"kernel": conv}, "d": {"kernel": dense}, "bn": bn},
                               "batch_stats": {"bn": stats}})
    np.testing.assert_array_equal(sd["c.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["d.weight"].numpy(), dense.T)
    y = rng.randn(4, 7).astype(np.float32)
    ref = (y - stats["BatchNorm_0"]["mean"]) / np.sqrt(stats["BatchNorm_0"]["var"] + 1e-3)
    ref = ref * bn["BatchNorm_0"]["scale"] + bn["BatchNorm_0"]["bias"]
    bn_mod = FrozenBatchNorm(7)
    bn_mod.load_state_dict({k[3:]: v for k, v in sd.items() if k.startswith("bn.")})
    with torch.no_grad():
        got = bn_mod(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_custom_backbone_and_fpn(models, stages):
    _, _, tmodel = models
    with torch.no_grad():
        pyramid = tmodel.features(torch.from_numpy(stages["images"]))
    assert len(pyramid) == 5
    for got, ref in zip(pyramid, stages["pyramid"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **TOL)


def test_resnet101_backbone_at_64():
    """The 3-px stem pad, the (0, 1) -inf stem max-pool and the 23-block
    ``res4a..res4w`` stage of ResNet-101."""
    x = np.random.RandomState(4).uniform(0.0, 1.0, (1, 64, 64, 3)).astype(np.float32)
    jnet = jbackbone.ResNet("resnet101")
    tree = _random_variables(jnet, x, seed=5)
    ref = jax.jit(jnet.apply)(tree, x)
    tnet = ResNet("resnet101")
    tnet.load_state_dict(W.flax_to_state_dict(tree))
    assert hasattr(tnet, "res4w") and not hasattr(tnet, "res4x")
    with torch.no_grad():
        got = tnet.eval()(_nchw(x).contiguous(memory_format=torch.channels_last))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), **TOL)


def test_rpn(models, stages):
    jmodel, tree, tmodel = models
    ref = _apply(jmodel, JaxMaskRCNN.rpn, tree, stages["pyramid"])
    with torch.no_grad():
        got = tmodel.rpn([_nchw(p) for p in stages["pyramid"]])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_heads(models):
    jmodel, tree, tmodel = models
    rng = np.random.RandomState(7)
    pooled = rng.randn(2, 5, 7, 7, 256).astype(np.float32)
    ref = _apply(jmodel, JaxMaskRCNN.classifier, tree, pooled)
    with torch.no_grad():
        got = tmodel.classifier(torch.from_numpy(pooled))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    pooled = rng.randn(2, 3, 14, 14, 256).astype(np.float32)
    ref = _apply(jmodel, JaxMaskRCNN.mask, tree, pooled)
    with torch.no_grad():
        got = tmodel.mask(torch.from_numpy(pooled))
    assert got.shape == (2, 3, 28, 28, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_proposals(stages):
    got, valid = generate_proposals(
        torch.from_numpy(stages["rpn_probs"]), torch.from_numpy(stages["rpn_bbox"]),
        torch.from_numpy(stages["anchors"]), torch.tensor(CFG.rpn_bbox_std_dev),
        proposal_count=CFG.post_nms_rois_inference, nms_threshold=CFG.rpn_nms_threshold,
        pre_nms_limit=CFG.pre_nms_limit,
    )
    np.testing.assert_array_equal(valid.numpy(), stages["valid"])
    np.testing.assert_allclose(got.numpy(), stages["proposals"], atol=1e-5)


def _refine_both(rois, probs, deltas, windows, min_conf=0.0):
    kw = dict(num_classes=4, max_instances=16, min_confidence=min_conf, nms_threshold=0.3)
    std = np.asarray(CFG.bbox_std_dev, np.float32)
    ref = np.asarray(jax_refine(rois, probs, deltas, windows, std, **kw))
    got = refine_detections(*(torch.tensor(a) for a in (rois, probs, deltas, windows, std)), **kw)
    return got.numpy(), ref


def test_refinement_on_jax_classifier_output(models, stages):
    """Refinement fed the JAX classifier's output on ROIAlign of the JAX
    proposals."""
    from caesar_mrcnn_tpu.ops.roi_align import multilevel_roi_align_batched

    jmodel, tree, _ = models
    pooled = multilevel_roi_align_batched(stages["pyramid"][:4], stages["proposals"], (64, 64), 7)
    _, probs, deltas = _apply(jmodel, JaxMaskRCNN.classifier, tree, pooled)
    windows = np.tile(np.array([0.0, 0.0, 1.0, 1.0], np.float32), (2, 1))
    got, ref = _refine_both(stages["proposals"], np.asarray(probs), np.asarray(deltas), windows)
    assert (ref[..., 4] > 0).sum() > 0
    np.testing.assert_array_equal(got[..., 4], ref[..., 4])
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("min_conf", [0.0, 0.5])
def test_refinement_multiclass(min_conf):
    """Several foreground classes (class-offset NMS, per-class cap), zero
    padded ROIs and a window narrower than the image."""
    rng = np.random.RandomState(8)
    b, r, c = 2, 80, 4
    y1, x1 = rng.uniform(0, 0.8, (2, b, r))
    rois = np.stack([y1, x1, np.minimum(y1 + rng.uniform(0.02, 0.3, (b, r)), 1.0),
                     np.minimum(x1 + rng.uniform(0.02, 0.3, (b, r)), 1.0)], -1).astype(np.float32)
    rois[:, -5:] = 0.0
    logits = rng.randn(b, r, c).astype(np.float32) * 2
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    deltas = (rng.randn(b, r, c, 4) * 0.1).astype(np.float32)
    windows = np.array([[0.0, 0.0, 1.0, 1.0], [0.1, 0.05, 0.9, 0.95]], np.float32)
    got, ref = _refine_both(rois, probs, deltas, windows, min_conf)
    assert len(np.unique(ref[..., 4])) > 2
    np.testing.assert_array_equal(got[..., 4], ref[..., 4])
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_box_deltas_and_clip():
    rng = np.random.RandomState(9)
    boxes = np.sort(rng.uniform(0, 1, (3, 50, 4)).astype(np.float32), axis=-1)[..., [0, 1, 2, 3]]
    deltas = (rng.randn(3, 50, 4) * np.array([0.5, 0.5, 3.0, 3.0])).astype(np.float32)  # hits the clamp
    ref = np.asarray(jboxes.apply_box_deltas_jax(jnp.asarray(boxes), jnp.asarray(deltas)))
    got = tboxes.apply_box_deltas(torch.from_numpy(boxes), torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    window = np.array([0.1, 0.2, 0.8, 0.9], np.float32)
    ref = np.asarray(jboxes.clip_boxes_jax(jnp.asarray(got), jnp.asarray(window)))
    np.testing.assert_array_equal(tboxes.clip_boxes(torch.from_numpy(got), torch.from_numpy(window)).numpy(), ref)
    pix = rng.randint(0, 100, (6, 4))
    np.testing.assert_array_equal(tboxes.norm_boxes(pix, (100, 120)), jboxes.norm_boxes(pix, (100, 120)))
    norm = rng.uniform(0, 1, (6, 4))
    np.testing.assert_array_equal(tboxes.denorm_boxes(norm, (100, 120)), jboxes.denorm_boxes(norm, (100, 120)))


def test_unmold_mask_and_resize_image_against_cv2():
    """torch bilinear (align_corners=False) in place of cv2.INTER_LINEAR:
    resized masks within 1e-3; after the 0.5 threshold identical except
    where cv2's value lies within 1e-5 of 0.5 (float rounding of the same
    sum; about 1e-4 of the pixels of u8-wire masks)."""
    rng = np.random.RandomState(10)
    ties = pixels = 0
    for k in range(200):
        mask = (np.round(rng.uniform(0, 1, (28, 28)) * 255) / 255).astype(np.float32)
        y1, x1 = rng.randint(0, 60, 2)
        bbox = (y1, x1, y1 + rng.randint(2, 90), x1 + rng.randint(2, 90))
        shape = (bbox[2] - bbox[0], bbox[3] - bbox[1])
        ref = jimage.resize(mask, shape)
        np.testing.assert_allclose(timage.resize(mask, shape), ref, atol=1e-3)
        tie = np.zeros((140, 150), bool)
        tie[bbox[0]:bbox[2], bbox[1]:bbox[3]] = np.abs(ref - 0.5) <= 1e-5
        ties, pixels = ties + tie.sum(), pixels + ref.size
        got = timage.unmold_mask(mask, bbox, (140, 150, 3))
        np.testing.assert_array_equal(got[~tie], jimage.unmold_mask(mask, bbox, (140, 150, 3))[~tie])
    assert ties <= 1e-3 * pixels
    for shape, mode, kw in [((100, 120, 3), "square", dict(min_dim=128, max_dim=128)),
                            ((300, 200, 3), "square", dict(min_dim=128, max_dim=128)),
                            ((100, 70, 3), "pad64", dict(min_dim=64)),
                            ((50, 60, 3), "none", {})]:
        image = rng.randint(0, 255, shape).astype(np.uint8)
        got = timage.resize_image(image, mode=mode, **kw)
        ref = jimage.resize_image(image, mode=mode, **kw)
        assert got[0].dtype == ref[0].dtype and got[0].shape == ref[0].shape
        assert np.abs(got[0].astype(int) - ref[0].astype(int)).max() <= 1  # u8 rounding
        assert got[1:4] == ref[1:4]


def test_image_meta_matches_jax():
    from caesar_mrcnn_tpu.models import meta as jmeta
    from caesar_mrcnn_tpu_torch.models import meta as tmeta

    args = (7, (100, 120, 3), (128, 128, 3), (11, 0, 117, 128), 1.0667, np.ones(4))
    got = tmeta.compose_image_meta(*args)
    np.testing.assert_array_equal(got, jmeta.compose_image_meta(*args))
    metas = np.stack([got, got * 2])
    ref = jmeta.parse_image_meta(metas)
    for key, value in tmeta.parse_image_meta(metas).items():
        np.testing.assert_array_equal(value, ref[key])
