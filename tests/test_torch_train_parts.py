"""The training modules of the port against the JAX package on the CPU at
f32, one module at a time, on seeded numpy inputs: batch-norm gradients,
the weight bridge, the ROIAlign gradient, crop_and_resize, RPN and
detection targets, losses, stage and decay masks, mold_batch, the data
pipeline and checkpoints. Tolerances are stated per test.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.data.generator import TrainingPipeline as JaxPipeline
from caesar_mrcnn_tpu.models import losses as JL
from caesar_mrcnn_tpu.models import targets as JT
from caesar_mrcnn_tpu.models.backbone import FrozenableBatchNorm
from caesar_mrcnn_tpu.ops.roi_align import crop_and_resize as jax_crop
from caesar_mrcnn_tpu.ops.roi_align import multilevel_roi_align_batched
from caesar_mrcnn_tpu.train import trainer as JTR
from caesar_mrcnn_tpu.utils import image as jimage
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
from caesar_mrcnn_tpu_torch.models import losses as TL
from caesar_mrcnn_tpu_torch.models import targets as TT
from caesar_mrcnn_tpu_torch.models.layers import FrozenBatchNorm
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from caesar_mrcnn_tpu_torch.ops.roi_align import crop_and_resize, roi_align, roi_align_backward
from caesar_mrcnn_tpu_torch.train import checkpoints as CK
from caesar_mrcnn_tpu_torch.train import trainer as TR
from caesar_mrcnn_tpu_torch.utils import image as timage
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors
from torch_train_fixtures import jax_config, jax_priorities, seeded_weights, tiny_config, tiny_dataset

torch.set_num_threads(2)

CFG = tiny_config()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("data"))


def test_frozen_batch_norm_gradients_equal_jax():
    """The repair: gamma and beta of a frozen batch norm train. Forward and
    d loss / d gamma, d beta equal jax.grad's within 1e-5 (f32 sums in
    another order)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 7).astype(np.float32)
    gout = rng.randn(2, 5, 6, 7).astype(np.float32)
    stats = {"mean": rng.randn(7).astype(np.float32), "var": rng.uniform(0.5, 2.0, 7).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32), "bias": rng.randn(7).astype(np.float32)}
    bn = FrozenableBatchNorm()

    def loss(p):
        y = bn.apply({"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": stats}}, x)
        return jnp.sum(y * gout), y

    (_, ref_y), ref_g = jax.value_and_grad(loss, has_aux=True)(params)
    mod = FrozenBatchNorm(7)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    y = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    (y * torch.from_numpy(gout).permute(0, 3, 1, 2)).sum().backward()
    assert mod.scale.grad is not None and mod.bias.grad is not None
    assert not mod.mean.requires_grad and not mod.var.requires_grad
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.scale.grad.numpy(), np.asarray(ref_g["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(ref_g["bias"]), rtol=1e-5, atol=1e-5)


def test_weight_bridge_round_trip_is_exact():
    """flax -> port -> flax gives the same tree, bit for bit, and every
    port tensor has the flax path of its leaf."""
    model, tree = seeded_weights(CFG)
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)
    back = W.state_dict_to_flax(W.flax_to_state_dict(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    for name in model.state_dict():
        coll, path = W.flax_path(name)
        assert jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k) for k in [coll, *path.split("/")])) in flat


def _pyramid(rng, b, size, c):
    return [rng.randn(b, size // 2**i, size // 2**i, c).astype(np.float32) for i in range(4)]


def _roi_boxes(rng, b, n):
    y1, x1 = rng.uniform(0, 0.8, (2, b, n))
    h, w = rng.uniform(0.01, 0.4, (2, b, n))
    boxes = np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1).astype(np.float32)
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, 1] = [0.2, 0.0, 1.0, 0.6]
    boxes[:, -3:] = 0.0
    return boxes


@pytest.mark.parametrize("pool", [7, 14])
def test_roi_align_gradient_equals_jax_vjp(pool):
    """The plain version's gradient in the levels (what the backward kernel
    is held to on the card) equals jax.vjp of multilevel_roi_align_batched
    within 1e-5; the wrapper on CPU tensors gives the same."""
    rng = np.random.RandomState(pool)
    feats = _pyramid(rng, 2, 64, 8)
    boxes = _roi_boxes(rng, 2, 30)
    gout = rng.randn(2, 30, pool, pool, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda *f: multilevel_roi_align_batched(list(f), jnp.asarray(boxes), (256, 256), pool),
                     *[jnp.asarray(f) for f in feats])
    ref = vjp(jnp.asarray(gout))
    levels = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    out = roi_align(levels, torch.from_numpy(boxes), (256, 256), pool)
    out.backward(torch.from_numpy(gout))
    direct = roi_align_backward(torch.from_numpy(gout), torch.from_numpy(boxes),
                                [f.shape[1:3] for f in feats], (256, 256))
    for lvl, r, d in zip(levels, ref, direct):
        np.testing.assert_allclose(lvl.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(d.numpy(), lvl.grad.numpy())


def test_crop_and_resize_equals_jax():
    """The plain crop of each ROI's assigned channel equals JAX's
    transpose + gather + crop_and_resize (targets.py:237-257) to 1e-6,
    for boxes inside, across and outside the map."""
    rng = np.random.RandomState(5)
    b, h, w, g, r = 2, 40, 36, 5, 12
    masks = (rng.rand(b, h, w, g) > 0.5).astype(np.float32) * rng.rand(b, h, w, g).astype(np.float32)
    boxes = _roi_boxes(rng, b, r)
    boxes[:, 2] = [-0.2, 0.5, 0.4, 1.3]
    boxes[:, 3] = [0.1, 0.1, 0.1, 0.1]
    assign = rng.randint(0, g, (b, r))
    got = crop_and_resize(torch.from_numpy(masks), torch.from_numpy(boxes), torch.from_numpy(assign), (28, 28))
    for i in range(b):
        roi_masks = np.transpose(masks[i], (2, 0, 1))[assign[i]]
        ref = jax.vmap(lambda m, bx: jax_crop(m, bx[None], (28, 28))[0])(roi_masks, boxes[i])
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "crowd", "empty"])
def test_build_rpn_targets_equals_jax(case):
    """Same anchors, GT and RandomState: match and deltas equal exactly."""
    anchors = get_anchors(CFG) * 63.0  # pixel coordinates
    rng = np.random.RandomState(6)
    n = {"plain": 5, "crowd": 5, "empty": 0}[case]
    y1, x1 = rng.randint(0, 40, (2, n))
    gt = np.stack([y1, x1, y1 + rng.randint(4, 24, n), x1 + rng.randint(4, 24, n)], 1).astype(np.int32)
    ids = rng.randint(1, 4, n).astype(np.int32)
    if case == "crowd":
        ids[0] = -1
    ref = JT.build_rpn_targets(anchors, ids, gt, jax_config(CFG), np.random.RandomState(1))
    got = TT.build_rpn_targets(anchors, ids, gt, CFG, np.random.RandomState(1))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert (got[0] == 1).sum() > 0 or case == "empty"


@pytest.mark.parametrize("mini", [True, False])
def test_detection_targets_with_jax_priorities(mini):
    """ROIs, class ids and masks equal exactly, deltas within 1e-5, with
    the priorities JAX draws from the same key; a crowd GT, padded GT and
    padded proposals included."""
    cfg = tiny_config(use_mini_mask=mini)
    rng = np.random.RandomState(7)
    b, p, g = 2, 50, 4
    mh, mw = (28, 28) if mini else (64, 64)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_ids = np.zeros((b, g), np.int32)
    gt_masks = (rng.rand(b, mh, mw, g) > 0.4).astype(np.float32)
    for i in range(b):
        y1, x1 = rng.uniform(0, 0.6, (2, 3))
        gt_boxes[i, :3] = np.stack([y1, x1, y1 + rng.uniform(0.1, 0.4, 3), x1 + rng.uniform(0.1, 0.4, 3)], 1)
        gt_ids[i, :3] = rng.randint(1, 4, 3)
    gt_ids[1, 2] = -1  # crowd
    jitter = rng.uniform(-0.03, 0.03, (b, p, 4)).astype(np.float32)
    props = np.clip(gt_boxes[:, rng.randint(0, 3, p)] + jitter, 0, 1)
    props[:, ::3] = _roi_boxes(rng, b, p)[:, ::3]
    props[:, -6:] = 0.0
    key = jax.random.PRNGKey(11)
    jcfg = jax_config(cfg)
    ref = jax.jit(lambda *a: JT.detection_targets_batch(*a, jcfg))(
        key, jnp.asarray(props), jnp.asarray(gt_ids), jnp.asarray(gt_boxes), jnp.asarray(gt_masks))
    got = TT.detection_targets(torch.from_numpy(props), torch.from_numpy(gt_ids), torch.from_numpy(gt_boxes),
                               torch.from_numpy(gt_masks), cfg, priorities=jax_priorities(key, b, p, cfg))
    rois, cls, deltas, masks = (np.asarray(r) for r in ref)
    assert (cls > 0).sum() >= 4 and (masks == 1).any()
    np.testing.assert_array_equal(got[0].numpy(), rois)
    np.testing.assert_array_equal(got[1].numpy(), cls)
    np.testing.assert_allclose(got[2].numpy(), deltas, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), masks)


def _loss_inputs(rng, b=2, a=60, r=12, c=4, m=6):
    match = rng.randint(-1, 2, (b, a)).astype(np.int32)
    match[1] = 0  # an image with no anchor in use
    cls = rng.randint(0, c, (b, r)).astype(np.int32)
    active = np.ones((b, c), np.float32)
    active[1, 2] = 0
    return dict(
        match=match, rpn_logits=(rng.randn(b, a, 2) * 3).astype(np.float32),
        rpn_target=rng.randn(b, a, 4).astype(np.float32), rpn_bbox=(rng.randn(b, a, 4) * 2).astype(np.float32),
        cls=cls, logits=(rng.randn(b, r, c) * 3).astype(np.float32), active=active,
        target_deltas=rng.randn(b, r, 4).astype(np.float32),
        pred_deltas=(rng.randn(b, r, c, 4) * 2).astype(np.float32),
        target_masks=(rng.rand(b, r, m, m) > 0.5).astype(np.float32),
        pred_masks=rng.uniform(0, 1, (b, r // 2, m, m, c)).astype(np.float32),
    )


@pytest.mark.parametrize("mask_loss", ["binary_crossentropy", "dice_coef_loss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_equal_jax(mask_loss, weighted):
    """Each of the five losses and the total within 1e-6 (relative), with
    per-image active classes, class weights and both mask losses."""
    d = _loss_inputs(np.random.RandomState(8))
    cw = np.array([0.5, 1.0, 2.0, 1.5], np.float32) if weighted else None
    cfg = tiny_config(mask_loss_function=mask_loss)

    def outputs(mod, asarray):
        return mod.TrainForward(
            rpn_class_logits=asarray(d["rpn_logits"]), rpn_bbox=asarray(d["rpn_bbox"]),
            class_logits=asarray(d["logits"]), bbox_deltas=asarray(d["pred_deltas"]),
            masks=asarray(d["pred_masks"]), target_class_ids=asarray(d["cls"]),
            target_deltas=asarray(d["target_deltas"]), target_masks=asarray(d["target_masks"]),
            rois=asarray(np.zeros((2, 12, 4), np.float32)),
        )

    from caesar_mrcnn_tpu.models import mask_rcnn as JM
    from caesar_mrcnn_tpu_torch.models import mask_rcnn as TM

    ref = JL.compute_losses(outputs(JM, jnp.asarray), jnp.asarray(d["match"]), jnp.asarray(d["rpn_target"]),
                            jnp.asarray(d["active"]), jax_config(cfg), None if cw is None else jnp.asarray(cw))
    got = TL.compute_losses(outputs(TM, torch.from_numpy), torch.from_numpy(d["match"]),
                            torch.from_numpy(d["rpn_target"]), torch.from_numpy(d["active"]), cfg,
                            None if cw is None else torch.from_numpy(cw))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    zero = TL.rpn_class_loss(torch.zeros(1, 5, dtype=torch.int32), torch.zeros(1, 5, 2))
    assert float(zero) == 0.0


@pytest.mark.parametrize("layers", ["heads", "3+", "4+", "5+", "all"])
def test_stage_and_decay_masks_select_the_jax_paths(layers):
    model, tree = seeded_weights(CFG)
    jmask = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(JTR.trainable_mask(tree["params"], layers))}
    jdecay = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(JTR.decay_mask(tree["params"]))}

    def key(name):
        return jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k) for k in W.flax_path(name)[1].split("/")))

    got = {key(n): v for n, v in TR.trainable_mask(model, layers).items()}
    assert got == jmask
    assert {key(n): v for n, v in TR.decay_mask(model).items()} == jdecay
    assert any(got.values()) and (layers == "all" or not all(got.values()))


@pytest.mark.parametrize("wire", ["compact", "dense"])
def test_pipeline_batches_and_mold_equal_jax(dataset, wire):
    """Same seed and augmentation: the port's pipeline gives JAX's batches
    key for key, and mold_batch JAX's molded tensors. Rule for the
    mini-masks: torch and cv2 bilinear may round a sum of exactly 0.5 to
    different sides; these masks are solid rectangles, whose crops resize
    to exactly 1, so they must be equal."""
    cfg = dataclasses.replace(CFG, train_wire=wire)
    ref_it = JaxPipeline(dataset, jax_config(cfg), seed=3, augmentation=True).batches()
    got_it = TrainingPipeline(dataset, cfg, seed=3, augmentation=True, cache_bytes=1 << 20).batches()
    for _ in range(3):
        ref, got = next(ref_it), next(got_it)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    jm = jax.device_get(JTR.mold_batch({k: jnp.asarray(v) for k, v in ref.items()}, jax_config(cfg)))
    tm = TR.mold_batch(TR.batch_to_device(got, "cpu"), cfg)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)


def test_mask_resizes_against_cv2():
    """resize_mask follows cv2's nearest rule exactly; minimize_mask equals
    cv2's except where cv2's bilinear value lies within 1e-5 of 0.5."""
    rng = np.random.RandomState(9)
    for scale in (0.5, 1.0, 1.37, 2.0):
        mask = rng.rand(37, 29, 3) > 0.5
        pad = [(3, 4), (1, 2), (0, 0)]
        np.testing.assert_array_equal(timage.resize_mask(mask, scale, pad), jimage.resize_mask(mask, scale, pad))
    ties = 0
    for _ in range(30):
        mask = rng.rand(50, 50, 2) > 0.3
        bbox = np.array([[3, 4, 3 + rng.randint(2, 40), 4 + rng.randint(2, 40)] for _ in range(2)])
        got = timage.minimize_mask(bbox, mask, (28, 28))
        ref = jimage.minimize_mask(bbox, mask, (28, 28))
        for i in range(2):
            y1, x1, y2, x2 = bbox[i]
            tie = np.abs(jimage.resize(mask[y1:y2, x1:x2, i], (28, 28)) - 0.5) <= 1e-5
            np.testing.assert_array_equal(got[..., i][~tie], ref[..., i][~tie])
            ties += int(tie.sum())
    assert ties < 0.05 * 30 * 2 * 28 * 28


def test_checkpoint_round_trip_and_partial_restore(tmp_path):
    model, _ = seeded_weights(CFG, seed=1)
    opt = TR.make_optimizer(tiny_config(optimizer="adam"), model)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.step()
    path = CK.save_train_state(str(tmp_path), "test", 2, model, opt, step=1)
    wpath = CK.save_checkpoint(str(tmp_path), "test", 3, model)
    assert CK.find_last(str(tmp_path)) == wpath and CK.epoch_from_path(path) == 2
    model2, _ = seeded_weights(CFG, seed=1)
    with torch.no_grad():
        for t in model2.state_dict().values():
            t.add_(1.0)
    opt2 = TR.make_optimizer(tiny_config(optimizer="adam"), model2)
    assert CK.load_train_state(path, model2, opt2) == 1 and opt2.count == 1
    for a, b in zip(model2.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(opt2.state["nu"], opt.state["nu"]))

    stored = CK.load_checkpoint(wpath)
    model6 = MaskRCNN(tiny_config(num_classes=6, class_names=("bkg", "a", "b", "c", "d", "e")))
    loaded, skipped = CK.partial_restore(model6, stored, exclude=[r"backbone/conv1"])
    assert "backbone.conv1.weight" in skipped and "backbone.res2a.conv1.weight" in loaded
    assert "classifier_head.mrcnn_class_logits.weight" in skipped
    assert torch.equal(model6.backbone.res2a.conv1.weight, model.backbone.res2a.conv1.weight)


def test_optimizer_step_leaves_the_raw_gradients():
    """The clip and the weight decay work on copies: after a step each
    ``.grad`` still holds the gradient back-propagation left (the card/CPU
    train parity of chip_smoke.py compares them)."""
    model, _ = seeded_weights(CFG, seed=1)
    opt = TR.make_optimizer(tiny_config(gradient_clip_norm=1e-3), model)
    raw = [torch.full_like(p, 0.5) for p in opt.params]
    before = [p.detach().clone() for p in opt.params]
    for p, g in zip(opt.params, raw):
        p.grad = g.clone()
    opt.step()
    assert all(torch.equal(p.grad, g) for p, g in zip(opt.params, raw))
    assert any(not torch.equal(p, b) for p, b in zip(opt.params, before))


@pytest.mark.parametrize("option", [dict(train_remat="backbone"), dict(train_bn=True),
                                    dict(train_remat="all"), dict(opt_state_dtype="bfloat16")])
def test_unported_training_options_raise(option):
    """Every training option of the JAX package is ported now: none raises
    ``NotImplementedError``, each builds a train step (its numerics are held
    to JAX by ``tests/test_torch_train_options.py`` and
    ``tests/test_torch_remat_moment.py``); an unknown remat policy or
    optimizer-state dtype raises ``ValueError``."""
    cfg = tiny_config(**option)
    model = MaskRCNN(cfg)
    assert callable(TR.make_train_step(model, TR.make_optimizer(cfg, model), get_anchors(cfg)))
    unknown = {"train_remat": "sometimes", "opt_state_dtype": "int8"}
    for name in set(option) & set(unknown):
        bad = tiny_config(**{name: unknown[name]})
        with pytest.raises(ValueError, match=name):
            TR.make_train_step(MaskRCNN(bad), TR.make_optimizer(bad, MaskRCNN(bad)), get_anchors(bad))


def test_train_loop_and_eval_step(dataset):
    """train_loop logs the losses of its last step; the eval step gives a
    train step's losses without changing the weights."""
    cfg = tiny_config(use_rpn_rois=False)
    model, _ = seeded_weights(cfg)
    anchors = get_anchors(cfg)
    batch = next(TrainingPipeline(dataset, cfg, seed=2).batches())
    ev = TR.make_eval_step(model, anchors)
    before = {k: float(v) for k, v in ev(TR.batch_to_device(batch, "cpu"),
                                         generator=torch.Generator().manual_seed(1)).items()}
    again = {k: float(v) for k, v in ev(TR.batch_to_device(batch, "cpu"),
                                        generator=torch.Generator().manual_seed(1)).items()}
    assert before == again
    step = TR.make_train_step(model, TR.make_optimizer(cfg, model), anchors)
    first = step(TR.batch_to_device(batch, "cpu"), generator=torch.Generator().manual_seed(1))
    assert {k: float(v) for k, v in first.items()} == pytest.approx(before, rel=1e-6)
    seen = []
    history = TR.train_loop(step, iter([batch, batch]), 2, "cpu", generator=torch.Generator().manual_seed(1),
                            log_every=1, callback=lambda i, h: seen.append(i))
    assert seen == [1, 2] and set(history) == set(before) and np.isfinite(history["total_loss"])
