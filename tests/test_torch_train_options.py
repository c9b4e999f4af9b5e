"""``train_bn=True`` in the port against the JAX package on the CPU at f32:
the batch norm layer against flax's ``nn.BatchNorm``, the train step
against ``make_train_step`` (SGD and Adam; ``layers`` ``all`` and
``heads``; under gradient accumulation), the eval step against
``make_eval_step``, and what may and may not move the running statistics.

Tolerances are those of ``tests/test_torch_train_steps.py``: losses within
1e-4 relative, each parameter and running mean/var tensor within 1e-4 of
its scale (``torch_train_fixtures.param_errors``), with Adam's bounded
exceptions for elements whose gradient is within rounding noise of zero.

Conditioning. Under ``train_bn`` every batch norm divides by its batch's
standard deviation, so f32 rounding grows layer by layer: at this config
the port's f32 forward is within 8e-6 of its own f64 evaluation, while the
JAX step's is 1e-4-1e-3 away from it where the inputs carry a large mean
(XLA's f32 sums of ``x`` and ``x^2`` for flax's ``E[x^2] - E[x]^2``). So
these cases use the dataset's mean pixel as ``mean_pixel`` (97, where the
frozen-BN tests use 0) and unsettled weights: settling scales the stem by
1/255 for frozen BN's sake, which under batch statistics changes nothing
but makes every SGD step move the stem by more than its own size. Along a
trajectory the batch statistics make the f32 losses chaotic (the port
against its own f64 evaluation by step 3: 1e-3 apart with ``layers="all"``
at an SGD rate of 5e-4, 0.25 with the settled stem; 5e-3 with Adam at 1e-4
and ``layers="heads"``), so each step is held against JAX's step from the
same state (parameters, running statistics and optimizer state carried
across), as ``chip_smoke.py`` holds the card; the one well-conditioned
trajectory, SGD with ``layers="heads"`` (within 2e-5 of f64), is held as
it is.
"""

import logging
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from caesar_mrcnn_tpu.data.generator import TrainingPipeline as JaxPipeline
from caesar_mrcnn_tpu.models.losses import compute_losses as jax_losses
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN, forward_train as jax_forward_train
from caesar_mrcnn_tpu.models.meta import parse_image_meta_jax
from caesar_mrcnn_tpu.train.trainer import (create_train_state, make_eval_step as jax_eval_step,
                                            make_optimizer as jax_optimizer, make_train_step as jax_train_step,
                                            mold_batch as jax_mold_batch)
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.models import layers as L
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN, forward_train
from caesar_mrcnn_tpu_torch.train import trainer as TR
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors
from torch_train_fixtures import (jax_config, jax_priorities, jax_state_from, param_errors, seeded_weights,
                                  tiny_config, tiny_dataset)

torch.set_num_threads(2)

MEAN_PIXEL = (97.0, 97.0, 97.0)  # the tiny dataset's mean pixel (97.17)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("data"))


def bn_config(**kw):
    return tiny_config(use_rpn_rois=False, train_bn=True, mean_pixel=MEAN_PIXEL, **kw)


def _batches(dataset, cfg, n, seed=5):
    it = JaxPipeline(dataset, jax_config(cfg), seed=seed).batches()
    return [next(it) for _ in range(n)]


def _priorities(k, batch, cfg):
    key = jax.random.PRNGKey(100 + k)
    return key, jax_priorities(key, cfg.batch_size, batch["rois"].shape[1], cfg)


def _check_losses(got, ref, tol=1e-4):
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=tol, err_msg=name)


# biases of the convolutions that a batch norm follows: under batch
# statistics they cancel out of the output, so their gradient is f32
# rounding noise, which Adam turns into steps of up to its rate either way
PRE_BN_BIAS = re.compile(r"(backbone/(.*/)?(conv\d|shortcut)|mrcnn_class_conv\d|mrcnn_mask_conv\d)/bias$")


def _check_tree(got, ref, start, lr=None, steps=1, tol=1e-4, fraction=1e-5, floor=2):
    """Every leaf within ``tol`` of its scale; with Adam's rate ``lr``, up
    to ``fraction`` of a tensor's elements (at least ``floor``) beyond it,
    and any element of a bias that a batch norm follows, each by no more
    than 2 * lr * steps."""
    for path, size, bad, err, rel in param_errors(got, ref, start, tol=tol):
        noise = PRE_BN_BIAS.search(path.replace("']['", "/").strip("[']"))
        allowed = (size if noise else max(floor, int(fraction * size))) if lr else 0
        assert bad <= allowed, (path, bad, rel)
        assert bad == 0 or err <= 2 * lr * steps, (path, err)


def _pre_bn_bias_gradients_are_noise(model):
    """The gradient of each bias that a batch norm follows is rounding
    noise: below 1e-4 of its kernel's largest gradient element."""
    grads = dict(model.named_parameters())
    checked = 0
    for name, p in grads.items():
        if p.grad is not None and name.endswith(".bias") and PRE_BN_BIAS.search(W.flax_path(name)[1]):
            kernel = grads[name[:-len("bias")] + "weight"].grad
            assert p.grad.abs().max() <= 1e-4 * kernel.abs().max(), (name, float(p.grad.abs().max()))
            checked += 1
    return checked


def _moment_errors(opt, jstate):
    """Relative L2 error of each of the port's Adam moments (``mu`` and
    ``nu``, per parameter tensor) against optax's after the same step,
    leaving out the biases that a batch norm follows (their gradients are
    noise); the worst (error, path) of each."""
    port = {k: W.state_dict_to_flax({n: t.double() for n, t in v.items()})["params"]
            for k, v in opt.state_dict()["state"].items()}
    worst = {"mu": (0.0, ""), "nu": (0.0, "")}

    def visit(path, leaf):
        names = [getattr(p, "name", None) for p in path]
        kind = next((k for k in worst if k in names), None)
        if kind is None:
            return
        keys = [p.key for p in path[names.index(kind) + 1:]]
        if PRE_BN_BIAS.search("/".join(keys)):
            return
        node = port[kind]
        for k in keys:
            node = node[k]
        ref = np.asarray(leaf, np.float64)
        err = float(np.linalg.norm(np.asarray(node) - ref) / max(np.linalg.norm(ref), 1e-30))
        worst[kind] = max(worst[kind], (err, "/".join(keys)))

    jax.tree_util.tree_map_with_path(visit, jax.device_get(jstate.opt_state))
    return worst


def _update_error(model, tx, jbefore, params):
    """The port's step against optax's ``tx.update`` (jitted, as the JAX
    step runs it) of the port's own gradients from the same state: the
    worst relative L2 error of a parameter tensor's update. This holds the
    optimizer's arithmetic (clipping, weight decay, moments, bias
    correction, the stage mask) apart from the two frameworks' gradient
    noise."""
    grads = W.state_dict_to_flax({n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().clone()
                                  for n, p in model.named_parameters()})["params"]
    updates, _ = jax.jit(tx.update)(grads, jbefore.opt_state, jbefore.params)
    worst = (0.0, "")
    for (path, ref), got, start in zip(jax.tree_util.tree_leaves_with_path(jax.device_get(updates)),
                                       jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jbefore.params)):
        ref = np.asarray(ref, np.float64)
        moved = np.asarray(got, np.float64) - np.asarray(start, np.float64)
        if PRE_BN_BIAS.search(jax.tree_util.keystr(path).replace("']['", "/").strip("[']")):
            continue
        if np.linalg.norm(ref) > 0:
            worst = max(worst, (float(np.linalg.norm(moved - ref) / np.linalg.norm(ref)), jax.tree_util.keystr(path)))
        else:
            assert not moved.any(), jax.tree_util.keystr(path)
    return worst


def _port_trees(model):
    """(params, batch_stats) of the model, copied (``.numpy()`` of a CPU
    tensor shares its memory)."""
    tree = W.state_dict_to_flax({k: v.clone() for k, v in model.state_dict().items()})
    return tree["params"], tree["batch_stats"]


# ----------------------------------------------------------------- the layer


@pytest.mark.parametrize("shape", [(6, 8, 5, 7), (40, 16)])
def test_batch_norm_layer_equals_flax(shape):
    """The port's BatchNorm inside ``batch_statistics`` against flax's
    ``BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)``
    on NCHW (flax: NHWC) and [N, C] inputs with a nonzero mean: the output,
    the committed running statistics, and the gradients of a loss with
    respect to the input, scale and bias, within 1e-5. The obvious torch
    version, ``F.batch_norm(training=True)``, is another update: with
    flax's momentum 0.99 it keeps 1% of the running variance, and with
    torch's 0.01 it still commits the unbiased variance (more than 2e-5
    relative away here)."""
    rng = np.random.RandomState(3)
    c = shape[1]
    x = (rng.randn(*shape) * 2.0 + 3.0).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    mean0 = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)

    to_nhwc = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def jloss(params, xj):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xj, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w.transpose(to_nhwc))), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x.transpose(to_nhwc)))

    layer = L.BatchNorm(c)
    with torch.no_grad():
        for t, v in ((layer.scale, scale), (layer.bias, bias), (layer.mean, mean0), (layer.var, var0)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    holder = torch.nn.Module()
    holder.bn = layer
    with L.batch_statistics(holder) as stats:
        y = layer(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert torch.equal(layer.mean, torch.from_numpy(mean0)), "a forward moved the running mean"
    L.commit_batch_stats(holder, stats)

    back = tuple(np.argsort(to_nhwc))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy).transpose(back), atol=1e-5)
    np.testing.assert_allclose(layer.mean.numpy(), np.asarray(jstats["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(layer.var.numpy(), np.asarray(jstats["var"]), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx).transpose(back), atol=1e-5)
    np.testing.assert_allclose(layer.scale.grad.numpy(), np.asarray(jgp["scale"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(jgp["bias"]), rtol=1e-5, atol=1e-4)

    for momentum, off in ((0.99, 0.1), (0.01, 2e-5)):
        naive_var = torch.from_numpy(var0).clone()
        F.batch_norm(torch.from_numpy(x), torch.from_numpy(mean0).clone(), naive_var, training=True,
                     momentum=momentum, eps=1e-3)
        assert np.abs(naive_var.numpy() / np.asarray(jstats["var"]) - 1).max() > off, momentum


def test_detect_and_export_modules_keep_the_running_statistics():
    """Outside a ``batch_statistics`` block the trainable batch norm is the
    frozen one, bit for bit (detect, the int8 fold and export read it)."""
    torch.manual_seed(0)
    frozen, trainable = L.FrozenBatchNorm(8), L.BatchNorm(8)
    with torch.no_grad():
        frozen.mean.uniform_(-1, 1)
        frozen.var.uniform_(0.5, 2.0)
    trainable.load_state_dict(frozen.state_dict())
    x = torch.randn(3, 8, 5, 5)
    assert torch.equal(trainable(x), frozen(x))


# ------------------------------------------------------------ the train step


# Adam under batch statistics: the gradients of the two frameworks differ
# by up to 1e-2 (relative L2; test_train_bn_gradients_equal_jax), and
# Adam turns every element whose gradient lies within that noise of zero
# into a step of up to its rate the other way: measured from the same
# state, 0.6% of mrcnn_mask_conv1's elements, 1.1% of the custom
# backbone's res4a/conv2 and 3% of res5a/conv2 (whose batch norms see 8
# values per channel) beyond 1e-4 of the tensor's scale, each within
# 1.9 * lr. So against JAX's step the parameters are held element by
# element within 2 * lr only (any share of a tensor may exceed 1e-4 of its
# scale), and the losses and running statistics as for SGD. What holds the
# update itself: optax's update of the port's own gradients from the same
# state (_update_error), per tensor by relative L2 within
# ADAM_UPDATE_BOUND (measured: 6.7e-4 at worst, batch norm scales whose
# clipped gradient and weight decay nearly cancel, where the two
# frameworks' f32 global norms, 5e-6 apart, tell), and the moments against
# JAX's step, per tensor by relative L2 within ADAM_MOMENT_BOUND (measured:
# mu 3.1e-2 and nu 4.6e-2 at worst, the second step's batch norm
# parameters in res2b and mrcnn_mask_bn1, whose gradients are the
# noisiest). An update without bias correction or weight decay, or a
# moment that misses a term or takes the other's rate, is O(1e-1) away.
ADAM_FRACTION, ADAM_FLOOR = 1.0, 0
ADAM_MOMENT_BOUND, ADAM_UPDATE_BOUND = 0.1, 5e-3


@pytest.mark.parametrize("optimizer,lr,layers", [("sgd", 5e-4, "all"), ("adam", 1e-4, "all"), ("sgd", 5e-4, "heads"),
                                                  ("adam", 1e-4, "heads")])
def test_train_bn_steps_equal_jax_from_the_same_state(dataset, optimizer, lr, layers):
    """Three steps along the port's trajectory, each against JAX's step
    from the port's state before it (module docstring): losses,
    parameters and committed running statistics. Under ``layers="heads"``
    the frozen backbone's running statistics update too, as in JAX (the
    stage mask stops parameter updates only)."""
    cfg = bn_config(optimizer=optimizer, learning_rate=lr)
    model, tree = seeded_weights(cfg, settle=False)
    anchors = get_anchors(cfg)
    opt = TR.make_optimizer(cfg, model, layers)
    step = TR.make_train_step(model, opt, anchors)
    tx = jax_optimizer(jax_config(cfg), tree["params"], layers)
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, anchors)
    moved = 0.0
    for k, batch in enumerate(_batches(dataset, cfg, 3)):
        key, prio = _priorities(k, batch, cfg)
        before = _port_trees(model)
        jbefore = jax_state_from(model, opt, tx)  # the step donates its own copy
        jstate, jl = jstep(jax_state_from(model, opt, tx), batch, key)
        tl = step(TR.batch_to_device(batch, "cpu"), priorities=prio)
        _check_losses(tl, jl)
        assert _pre_bn_bias_gradients_are_noise(model) == (47 if layers == "all" else 6)
        params, stats = _port_trees(model)
        _check_tree(params, jax.device_get(jstate.params), before[0], lr if optimizer == "adam" else None,
                    fraction=ADAM_FRACTION, floor=ADAM_FLOOR)
        _check_tree(stats, jax.device_get(jstate.batch_stats), before[1])
        if optimizer == "adam":
            assert _update_error(model, tx, jbefore, params)[0] <= ADAM_UPDATE_BOUND, k
            for kind, (err, path) in _moment_errors(opt, jstate).items():
                assert err <= ADAM_MOMENT_BOUND, (k, kind, err, path)
        moved = max(moved, max(e[3] for e in param_errors(stats["backbone"], before[1]["backbone"])))
    assert moved > 1e-3, "the backbone's running statistics did not move"
    if layers == "heads":
        assert all(e[3] == 0.0 for e in param_errors(params["backbone"], tree["params"]["backbone"]))


def test_train_bn_gradients_equal_jax(dataset):
    """The gradient of every parameter after one ``layers="all"`` step
    against ``jax.grad`` of the JAX step's loss (its ``forward_train`` and
    ``compute_losses``), per tensor by relative L2 error, bound 3e-2.
    Measured: up to 9.8e-3 (the mask head); the port's f32 gradients are
    as far from their own f64 evaluation (5.8e-3 there), ReLU inputs near 0
    flipping under the batch statistics' rounding. Gradients that skip the
    statistics (``mean.detach()``) are off by more than 0.3. The biases a
    batch norm follows are noise in both (checked below 1e-4 of their
    kernel's gradient instead)."""
    cfg = bn_config()
    model, tree = seeded_weights(cfg, settle=False)
    batch = _batches(dataset, cfg, 1)[0]
    key, prio = _priorities(0, batch, cfg)
    jcfg = jax_config(cfg)
    jmodel = JaxMaskRCNN(jcfg)
    b = jax_mold_batch(batch, jcfg)

    def loss(params):
        out, _ = jax_forward_train(jmodel, {"params": params, "batch_stats": tree["batch_stats"]}, key, b["images"],
                                   b["gt_class_ids"], b["gt_boxes"], b["gt_masks"], jnp.asarray(get_anchors(cfg)),
                                   ext_rois=b["rois"])
        meta = parse_image_meta_jax(b["image_meta"])
        return jax_losses(out, b["rpn_match"], b["rpn_deltas"], meta["active_class_ids"], jcfg)["total_loss"]

    ref = W.flax_to_state_dict({"params": jax.device_get(jax.jit(jax.grad(loss))(tree["params"]))})
    step = TR.make_train_step(model, TR.make_optimizer(cfg, model, "all"), get_anchors(cfg))
    step(TR.batch_to_device(batch, "cpu"), priorities=prio)
    assert _pre_bn_bias_gradients_are_noise(model) == 47
    worst = (0.0, "")
    for name, p in model.named_parameters():
        if name.endswith(".bias") and PRE_BN_BIAS.search(W.flax_path(name)[1]):
            continue
        r = ref[name].double()
        worst = max(worst, (float((p.grad.double() - r).norm() / r.norm()), name))
    assert worst[0] <= 3e-2, worst


def test_train_bn_heads_sgd_trajectory_equals_jax(dataset):
    """``layers="heads"`` with SGD, whose trajectory is well conditioned
    (module docstring): three steps of each trainer from the same
    weights, held after every step and at the end."""
    cfg = bn_config(optimizer="sgd", learning_rate=5e-4)
    model, tree = seeded_weights(cfg, settle=False)
    anchors = get_anchors(cfg)
    state, tx = create_train_state(jax_config(cfg), tree, "heads")
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, anchors)
    step = TR.make_train_step(model, TR.make_optimizer(cfg, model, "heads"), anchors)
    for k, batch in enumerate(_batches(dataset, cfg, 3)):
        key, prio = _priorities(k, batch, cfg)
        state, jl = jstep(state, batch, key)
        _check_losses(step(TR.batch_to_device(batch, "cpu"), priorities=prio), jl)
    params, stats = _port_trees(model)
    _check_tree(params, jax.device_get(state.params), tree["params"])
    _check_tree(stats, jax.device_get(state.batch_stats), tree["batch_stats"])


def test_train_bn_commits_the_statistics_every_micro_step(dataset):
    """``grad_accum_steps=2`` (``optax.MultiSteps``): the running
    statistics move on every micro-step, the parameters on every second,
    as in JAX's step, whose ``step_fn`` runs per micro-batch."""
    cfg = bn_config(optimizer="sgd", learning_rate=5e-4, grad_accum_steps=2)
    model, tree = seeded_weights(cfg, settle=False)
    anchors = get_anchors(cfg)
    state, tx = create_train_state(jax_config(cfg), tree, "all")
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, anchors)
    step = TR.make_train_step(model, TR.make_optimizer(cfg, model, "all"), anchors)
    prev = _port_trees(model)
    for k, batch in enumerate(_batches(dataset, cfg, 2)):
        key, prio = _priorities(k, batch, cfg)
        state, jl = jstep(state, batch, key)
        _check_losses(step(TR.batch_to_device(batch, "cpu"), priorities=prio), jl)
        params, stats = _port_trees(model)
        _check_tree(stats, jax.device_get(state.batch_stats), tree["batch_stats"])
        _check_tree(params, jax.device_get(state.params), tree["params"])
        assert max(e[3] for e in param_errors(stats, prev[1])) > 1e-3, f"micro-step {k}: statistics not committed"
        moved = max(e[3] for e in param_errors(params, prev[0]))
        assert (moved > 0) == (k == 1), (k, moved)
        prev = params, stats


def test_eval_step_uses_the_batch_statistics_and_commits_nothing(dataset):
    """The eval step under ``train_bn`` equals JAX's ``make_eval_step``
    (which calls ``forward_train`` and drops the new statistics), and the
    running statistics do not move; they differ from the frozen-BN losses
    of the same weights."""
    cfg = bn_config()
    model, tree = seeded_weights(cfg, settle=False)
    anchors = get_anchors(cfg)
    batch = _batches(dataset, cfg, 1)[0]
    key, prio = _priorities(0, batch, cfg)
    state, _ = create_train_state(jax_config(cfg), tree, "all")
    jl = jax_eval_step(JaxMaskRCNN(jax_config(cfg)), anchors)(state, batch, key)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tl = TR.make_eval_step(model, anchors)(TR.batch_to_device(batch, "cpu"), priorities=prio)
    _check_losses(tl, jl)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    frozen, _ = seeded_weights(tiny_config(use_rpn_rois=False, mean_pixel=MEAN_PIXEL), settle=False)
    fl = TR.make_eval_step(frozen, anchors)(TR.batch_to_device(batch, "cpu"), priorities=prio)
    assert abs(float(fl["total_loss"]) - float(tl["total_loss"])) > 1e-3


def test_forward_train_leaves_the_running_statistics(dataset):
    """A forward alone (``chip_smoke.py``'s capture, an eval) returns the
    batch statistics of every batch norm and moves none of the running
    ones; the train step then commits ``0.99 * running + 0.01 * batch``."""
    cfg = bn_config()
    model, _ = seeded_weights(cfg, settle=False)
    anchors = get_anchors(cfg)
    b = TR.mold_batch(TR.batch_to_device(_batches(dataset, cfg, 1)[0], "cpu"), cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = forward_train(model, b["images"], b["gt_class_ids"], b["gt_boxes"], b["gt_masks"],
                        torch.from_numpy(anchors).float(), torch.tensor(cfg.rpn_bbox_std_dev), ext_rois=b["rois"],
                        generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    layers = [n for n, m in model.named_modules() if isinstance(m, L.BatchNorm)]
    assert sorted(out.batch_stats) == sorted(layers) and len(layers) == 1 + 3 * 3 + 4 * 3 + 2 * 3 + 3 * 3 + 4 + 2 + 4
    L.commit_batch_stats(model, out.batch_stats)
    mean, var = out.batch_stats["mask_head.mrcnn_mask_bn1"]
    np.testing.assert_allclose(model.mask_head.mrcnn_mask_bn1.var.numpy(),
                               (0.99 * before["mask_head.mrcnn_mask_bn1.var"] + 0.01 * var).numpy(), rtol=1e-6)
    assert model.backbone.bn_conv1.sink is None  # the block is closed


def test_frozen_model_returns_no_statistics(dataset):
    cfg = tiny_config(use_rpn_rois=False)
    model, _ = seeded_weights(cfg)
    b = TR.mold_batch(TR.batch_to_device(_batches(dataset, cfg, 1)[0], "cpu"), cfg)
    out = forward_train(model, b["images"], b["gt_class_ids"], b["gt_boxes"], b["gt_masks"],
                        torch.from_numpy(get_anchors(cfg)).float(), torch.tensor(cfg.rpn_bbox_std_dev),
                        ext_rois=b["rois"], generator=torch.Generator().manual_seed(0))
    assert out.batch_stats is None
    assert not any(isinstance(m, L.BatchNorm) for m in model.modules())


# ------------------------------------------------------------------- remat


def test_train_bn_with_remat_warns_and_runs_without_it(dataset, caplog):
    """As the JAX package: remat is ignored under ``train_bn`` with a
    warning, and the step equals the ``train_bn`` step without remat bit
    for bit."""
    results = []
    for remat in ("none", "all"):
        cfg = bn_config(train_remat=remat)
        model, _ = seeded_weights(cfg, settle=False)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            step = TR.make_train_step(model, TR.make_optimizer(cfg, model, "all"), get_anchors(cfg))
        warned = [r.getMessage() for r in caplog.records if "train_remat" in r.getMessage()]
        assert bool(warned) == (remat != "none"), warned
        batch = _batches(dataset, cfg, 1)[0]
        losses = step(TR.batch_to_device(batch, "cpu"), priorities=_priorities(0, batch, cfg)[1])
        results.append((losses, model.state_dict()))
    (l0, s0), (l1, s1) = results
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.parametrize("option", [dict(train_remat="everything"), dict(train_remat="backbone+heads")])
def test_unknown_remat_policy_raises(option):
    cfg = tiny_config(**option)
    model = MaskRCNN(cfg)
    with pytest.raises(ValueError, match="unknown train_remat"):
        TR.make_train_step(model, TR.make_optimizer(cfg, model), get_anchors(cfg))
