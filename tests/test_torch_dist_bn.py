"""``train_bn=True`` under the port's data parallelism on the CPU: two real
Gloo processes (``tests/torch_dist_worker.py``'s ``train`` case, as in
``tests/test_torch_dist.py``) whose batch norms normalize with the global
batch's statistics (each layer's ``(sum x, sum x^2)`` summed over the ranks
under autograd, ``parallel.dist.all_reduce_sum``), on the dataset of
``tests/test_torch_dist.py`` whose two ranks hold 2 and 7 GT objects:

* an SGD step against the one-process port on the global batch from the
  same weights: losses, parameters and running statistics within 1e-5
  (relative, and of each tensor's scale); the ranks' parameters and
  statistics bit-equal;
* against the JAX package's step sharded over a 2-device mesh (one jitted
  program over the global batch, so its statistics are the global
  batch's) from the same state: losses and statistics within 1e-4,
  parameters within 1e-4 of their scale.

One step: ``tests/test_torch_train_options.py`` explains why a ``train_bn``
trajectory is held step by step. Here the second step's losses of two
ranks and of one process, whose parameters after the first step differ in
the last bits, were already 4e-5 apart, while one process against JAX's
mesh step from its own state stayed within 3e-6;
* the negative control: with each rank's own statistics (the batch norms
  of each half of the global batch normalizing with that half's), the
  loss differs by more than 1e-3.

Inputs as in ``tests/test_torch_train_options.py``: unsettled weights, the
dataset's mean pixel (79) as ``mean_pixel``, given ROIs and priorities.
"""

import jax
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from caesar_mrcnn_tpu.train.trainer import make_optimizer as jax_optimizer, make_train_step as jax_train_step
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.models import layers as L
from caesar_mrcnn_tpu_torch.train import trainer as TR
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors
from test_torch_dist import _batches, run_workers, write_dataset
from torch_train_fixtures import (jax_config, jax_priorities, jax_state_from, param_errors, seeded_weights,
                                  tiny_config)

torch.set_num_threads(2)

MEAN_PIXEL = (79.0, 79.0, 79.0)  # the dataset's mean pixel (79.1)
STEPS = 1  # a train_bn trajectory is chaotic in f32 from the second step on (module docstring)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("data"))


def _config():
    """Global batch 4 over two ranks, SGD, trainable batch norm."""
    return tiny_config(use_rpn_rois=False, images_per_device=2, num_devices=2, train_bn=True,
                       mean_pixel=MEAN_PIXEL, learning_rate=5e-4)


def _inputs(dataset, cfg):
    batches = _batches(dataset, cfg, STEPS)
    keys = [jax.random.PRNGKey(100 + k) for k in range(STEPS)]
    priorities = [jax_priorities(key, cfg.batch_size, b["rois"].shape[1], cfg) for key, b in zip(keys, batches)]
    return batches, keys, priorities


def _trees(state):
    tree = W.state_dict_to_flax({k: v.clone() for k, v in state.items()})
    return tree["params"], tree["batch_stats"]


def _within(got, ref, start, tol):
    for path, size, bad, err, rel in param_errors(got, ref, start, tol=tol):
        assert bad == 0, (path, bad, rel)


def test_dp_train_bn_equals_one_process_and_jax_mesh(dataset, tmp_path):
    cfg = _config()
    batches, keys, priorities = _inputs(dataset, cfg)
    model, tree = seeded_weights(cfg, settle=False)
    torch.save({"config": cfg, "state": model.state_dict(), "batches": batches, "priorities": priorities,
                "seed": 0}, tmp_path / "train_inputs.pt")
    run_workers("train", tmp_path)
    ranks = [torch.load(tmp_path / f"train_rank{r}.pt", weights_only=False) for r in (0, 1)]
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"]), \
        "the ranks' parameters or statistics differ"

    # one process on the global batch, from the same weights; and JAX's mesh step from its state before each step
    opt = TR.make_optimizer(cfg, model, "all")
    step = TR.make_train_step(model, opt, get_anchors(cfg))
    mesh = make_mesh(n_devices=2)
    tx = jax_optimizer(jax_config(cfg), tree["params"], "all")
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, get_anchors(cfg), mesh=mesh)
    with mesh:
        for k, (batch, key, prio) in enumerate(zip(batches, keys, priorities)):
            before = _trees(model.state_dict())
            jstate, jl = jstep(replicate_tree(jax_state_from(model, opt, tx), mesh), shard_batch(batch, mesh), key)
            one = step(TR.batch_to_device(batch, "cpu"), priorities=prio)
            for name in jl:
                np.testing.assert_allclose(float(ranks[0]["losses"][k][name]), float(one[name]), rtol=1e-5,
                                           err_msg=name)
                np.testing.assert_allclose(float(one[name]), float(jl[name]), rtol=1e-4, err_msg=name)
            params, stats = _trees(model.state_dict())
            _within(params, jax.device_get(jstate.params), before[0], 1e-4)
            _within(stats, jax.device_get(jstate.batch_stats), before[1], 1e-4)
    dp_params, dp_stats = _trees(ranks[0]["state"])
    _within(dp_params, params, tree["params"], 1e-5)
    _within(dp_stats, stats, tree["batch_stats"], 1e-5)
    assert max(e[3] for e in param_errors(stats, tree["batch_stats"])) > 1e-3


def test_per_rank_statistics_are_another_loss(dataset, monkeypatch):
    """The negative control: the eval step on the global batch with each
    half's own statistics (what two ranks without the all-reduce would
    compute; the rows of the backbone, of the classifier's [B*R, fc] and of
    the mask head's [B*Rp, ...] inputs are in image order, so each half is
    a rank's) against the global statistics."""
    cfg = _config()
    batches, _, priorities = _inputs(dataset, cfg)
    model, _ = seeded_weights(cfg, settle=False)
    step = TR.make_eval_step(model, get_anchors(cfg))
    batch = TR.batch_to_device(batches[0], "cpu")
    whole = {k: float(v) for k, v in step(batch, priorities=priorities[0]).items()}
    forward = L.BatchNorm.forward

    def per_rank(self, x):
        if self.sink is None:
            return forward(self, x)
        halves = [forward(self, part) for part in x.chunk(2)]
        return torch.cat(halves)

    monkeypatch.setattr(L.BatchNorm, "forward", per_rank)
    own = {k: float(v) for k, v in step(batch, priorities=priorities[0]).items()}
    assert abs(own["total_loss"] - whole["total_loss"]) > 1e-3, (own, whole)
