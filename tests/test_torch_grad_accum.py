"""Gradient accumulation (``grad_accum_steps = 2``) in the port's optimizer
against the JAX package's ``make_train_step`` under ``optax.MultiSteps``, on
the CPU at f32, with the harness and tolerances of
``tests/test_torch_train_steps.py``: four micro-steps on four pipeline
batches (given ROIs, so that near-tied proposals cannot fork the targets),
from the same weights and with the same sampling priorities.

Held after every micro-step: the losses within 1e-4 relative, and the
parameters against JAX's within 1e-4 of each tensor's scale. For Adam, up
to 1e-5 of a tensor's elements, and at least 3, may exceed it by no more
than 2 * learning rate * updates: Adam divides each element by its own
running magnitude, so f32 summation noise in a gradient moves it further
(the port against itself at one and two threads differs the same way), and
the stem's three input channels all see the one mono image, so one
element's noise shows three times. After the first micro-step of each
update the parameters have not moved at all, in either framework.
"""

import jax
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.data.generator import TrainingPipeline as JaxPipeline
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.train.trainer import create_train_state, make_train_step as jax_train_step
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.train import trainer as TR
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors
from torch_train_fixtures import jax_config, jax_priorities, param_errors, seeded_weights, tiny_config, tiny_dataset

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("data"))


@pytest.mark.parametrize("optimizer,lr", [("sgd", 5e-4), ("adam", 1e-4)])
def test_accumulated_updates_equal_optax_multisteps(dataset, optimizer, lr):
    cfg = tiny_config(use_rpn_rois=False, optimizer=optimizer, learning_rate=lr, grad_accum_steps=2)
    it = JaxPipeline(dataset, jax_config(cfg), seed=5).batches()
    batches = [next(it) for _ in range(4)]
    model, tree = seeded_weights(cfg)
    anchors = get_anchors(cfg)
    state, tx = create_train_state(jax_config(cfg), tree, "all")
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, anchors)
    opt = TR.make_optimizer(cfg, model, "all")
    step = TR.make_train_step(model, opt, anchors)
    start = prev = prev_ref = tree["params"]
    updates = 0
    for k, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + k)
        state, jl = jstep(state, batch, key)
        tl = step(TR.batch_to_device(batch, "cpu"),
                  priorities=jax_priorities(key, cfg.batch_size, batch["rois"].shape[1], cfg))
        for name in jl:
            np.testing.assert_allclose(float(tl[name]), float(jl[name]), rtol=1e-4, err_msg=name)
        got = W.state_dict_to_flax(model.state_dict())["params"]
        ref = jax.device_get(state.params)
        if k % 2 == 0:  # first micro-step of an update: nothing moves
            assert all(e[3] == 0.0 for e in param_errors(got, prev))
            assert all(e[3] == 0.0 for e in param_errors(ref, prev_ref))
        else:
            updates += 1
            assert opt.count == updates and opt.mini_step == 0
            for path, size, bad, err, rel in param_errors(got, ref, start):
                allowed = max(3, int(1e-5 * size)) if optimizer == "adam" else 0
                assert bad <= allowed, (k, path, bad, rel)
                assert bad == 0 or err <= 2 * lr * updates, (k, path, err)
            assert any(e[3] > 0 for e in param_errors(got, start)), "the update moved nothing"
        prev, prev_ref = got, ref
    assert updates == 2


def test_accumulation_state_round_trips_and_keeps_raw_grads(dataset):
    """Between updates the running mean is optimizer state: a state_dict
    taken after one micro-step, loaded into a fresh optimizer, gives the
    same update as the original; ``.grad`` stays each micro-step's raw
    gradient."""
    cfg = tiny_config(use_rpn_rois=False, optimizer="adam", learning_rate=1e-4, grad_accum_steps=2)
    it = JaxPipeline(dataset, jax_config(cfg), seed=5).batches()
    batches = [TR.batch_to_device(next(it), "cpu") for _ in range(2)]
    anchors = get_anchors(cfg)
    prio = jax_priorities(jax.random.PRNGKey(0), cfg.batch_size, batches[0]["rois"].shape[1], cfg)
    models, opts = [], []
    for _ in range(2):
        model, _ = seeded_weights(cfg)
        models.append(model)
        opts.append(TR.make_optimizer(cfg, model, "all"))
    steps = [TR.make_train_step(m, o, anchors) for m, o in zip(models, opts)]
    steps[0](batches[0], priorities=prio)
    raw = [p.grad.clone() for p in opts[0].params]
    assert opts[0].mini_step == 1 and opts[0].count == 0
    opts[1].load_state_dict(opts[0].state_dict())
    for s in steps:
        s(batches[1], priorities=prio)
    for p0, p1, g in zip(opts[0].params, opts[1].params, raw):
        assert torch.equal(p0.grad, p1.grad)
    assert any(not torch.equal(p.grad, g) for p, g in zip(opts[0].params, raw))
    for a, b in zip(models[0].state_dict().values(), models[1].state_dict().values()):
        assert torch.equal(a, b)
    assert opts[1].count == 1 and opts[1].mini_step == 0
