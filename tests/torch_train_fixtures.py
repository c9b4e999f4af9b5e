"""Shared inputs of the training parity tests (``tests/test_torch_train*.py``):
the tiny training config and FITS dataset of ``tests/test_train.py``, seeded
weights in both frameworks, and the JAX sampling priorities of a train step.
The port is given its own config (``caesar_mrcnn_tpu_torch.config``) and the
JAX package a twin of it with the same fields (:func:`jax_config`).
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import torch

from caesar_mrcnn_tpu.config import Config as JaxConfig
from caesar_mrcnn_tpu.train.trainer import TrainState
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.config import detector_config
from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from caesar_mrcnn_tpu_torch.models.targets import sampling_width
from caesar_mrcnn_tpu_torch.testing import settle_flax_weights
from caesar_mrcnn_tpu_torch.utils import fits as F

CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")


def tiny_config(**overrides):
    """``tests/test_train.py``'s tiny config, as the port's config: custom
    backbone, 64^2, 4 classes, f32, mini-masks, SGD."""
    kw = dict(
        backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=4,
        class_names=CLASS_NAMES, images_per_device=2, num_devices=1,
        rpn_anchor_scales=(8, 16, 32, 64, 128), rpn_train_anchors_per_image=64,
        pre_nms_limit=256, post_nms_rois_training=64, train_rois_per_image=32,
        max_gt_instances=4, detection_max_instances=8, compute_dtype="float32",
        use_mini_mask=True, mini_mask_shape=(28, 28), optimizer="sgd", learning_rate=0.002,
    )
    kw.update(overrides)
    return detector_config(**kw)


def jax_config(cfg):
    """The JAX package's config with every field of the port's ``cfg``."""
    return JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def tiny_dataset(tmp):
    """``tests/test_train.py``'s dataset: four 64^2 FITS images, each with
    one 14x14 square source and its mask."""
    ds = SourceDataset()
    ds.set_class_dict({"sidelobe": 1, "source": 2, "galaxy": 3})
    rng = np.random.RandomState(0)
    rows = []
    for i in range(4):
        img = rng.normal(0, 0.02, (64, 64)).astype(np.float32)
        y, x = 10 + 6 * i, 12 + 5 * i
        img[y:y + 14, x:x + 14] += 5.0
        mask = np.zeros((64, 64), np.float32)
        mask[y:y + 14, x:x + 14] = 1.0
        F.write_fits(img, str(tmp / f"img{i}.fits"))
        F.write_fits(mask, str(tmp / f"mask{i}.fits"))
        rows.append(f"{tmp}/img{i}.fits,{tmp}/mask{i}.fits,source")
    (tmp / "list.dat").write_text("\n".join(rows))
    assert ds.load_data_from_list(str(tmp / "list.dat")) == 0
    ds.prepare()
    return ds


_TREES = {}


def seeded_weights(cfg, seed=0, settle=True):
    """(port model, numpy flax tree) with the same weights: flax's default
    kernels from ``seed``, and biases and batch norms drawn nonzero (scale
    0.5..1.5, var 0.5..2, the rest +-0.1) so that no tensor starts at 0 and
    a parameter's relative error measures its gradient's; then, with
    ``settle``, settled (stem / 255, background bias -1) so that softmaxes
    do not saturate on raw 0..255 pixels. The tree is made once per config,
    seed and ``settle`` and shared: do not change it in place."""
    key = (repr(cfg), seed, settle)
    if key not in _TREES:
        model = MaskRCNN(cfg)
        W.init_weights(model, torch.Generator().manual_seed(seed))
        rng = np.random.RandomState(seed)

        def fill(path, leaf):
            name = path[-1].key
            if name == "kernel":
                return leaf
            low, high = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(name, (-0.1, 0.1))
            return rng.uniform(low, high, leaf.shape).astype(np.float32)

        tree = jax.tree_util.tree_map_with_path(fill, W.state_dict_to_flax(model.state_dict()))
        _TREES[key] = settle_flax_weights(tree) if settle else tree
    model = MaskRCNN(cfg)
    model.load_state_dict(W.flax_to_state_dict(_TREES[key]))
    return model, _TREES[key]


def jax_priorities(key, batch, num_proposals, cfg):
    """The uniform priorities ``detection_targets_batch`` draws from
    ``key``: one key per image (``targets.py:277``), split into the
    positive and negative keys (``targets.py:205-217``)."""
    width = sampling_width(num_proposals, cfg)
    pos, neg = [], []
    for k in jax.random.split(key, batch):
        kpos, kneg = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kpos, (width,))))
        neg.append(np.asarray(jax.random.uniform(kneg, (width,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def param_errors(got_tree, ref_tree, start_tree=None, tol=1e-4):
    """Per leaf of two flax trees: (path, size, elements beyond ``tol`` of
    the leaf's scale, largest |got - ref|, largest relative to the scale).
    The scale is the reference leaf's max-abs, or its largest change from
    ``start_tree`` where that is larger (a parameter that a step moves by
    more than its own size, such as the 1/255-scaled stem)."""
    starts = jax.tree_util.tree_leaves(start_tree) if start_tree is not None else None
    out = []
    for i, ((path, ref), got) in enumerate(zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                                               jax.tree_util.tree_leaves(got_tree))):
        ref = np.asarray(ref, np.float64)
        err = np.abs(np.asarray(got, np.float64) - ref)
        scale = np.abs(ref).max()
        if starts is not None:
            scale = max(scale, np.abs(ref - np.asarray(starts[i], np.float64)).max())
        scale = max(scale, 1e-30)
        out.append((jax.tree_util.keystr(path), ref.size, int((err > tol * scale).sum()),
                    float(err.max()), float(err.max() / scale)))
    return out


def jax_state_from(model, opt, tx):
    """The JAX train state of the port's model and optimizer: parameters,
    running statistics, and optax's moments and count in the places
    ``tx.init`` gives them."""
    tree = W.state_dict_to_flax({k: v.clone() for k, v in model.state_dict().items()})
    params, stats = tree["params"], tree.get("batch_stats", {})
    moments = {k: W.state_dict_to_flax({n: t.float() for n, t in v.items()})["params"]
               for k, v in opt.state_dict()["state"].items()}

    def fill(path, leaf):
        names = [getattr(p, "name", None) for p in path]
        for kind in ("mu", "nu", "trace"):
            if kind in names:
                node = moments[kind]
                for p in path[names.index(kind) + 1:]:
                    node = node[p.key]
                return jnp.asarray(np.array(node), leaf.dtype)  # a copy: the port's step updates in place
        if "count" in names:
            return jnp.asarray(opt.count, leaf.dtype)
        return leaf

    opt_state = jax.tree_util.tree_map_with_path(fill, tx.init(params))
    return TrainState(jnp.zeros((), jnp.int32), params, stats, opt_state)
