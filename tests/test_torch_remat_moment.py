"""``train_remat`` and ``opt_state_dtype="bfloat16"`` in the port against
itself and the JAX package on the CPU at f32, with the harness and
tolerances of ``tests/test_torch_train_steps.py`` (frozen batch norm,
settled weights, given ROIs, the JAX step's priorities).

Remat recomputes the same operations in the backward, so the port's remat
step equals its step without remat bit for bit. The bf16 first moment
follows the JAX trainer's jitted update (``train/trainer.py``,
``Optimizer._moment``): the decay weakly typed to bf16 (0.8984375), its
product with the stored moment kept in f32 (XLA does not round it to bf16
under ``jit``; optax run eagerly does), the update from the unrounded sum,
the stored moment rounded to nearest even.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from caesar_mrcnn_tpu.data.generator import TrainingPipeline as JaxPipeline
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.train.trainer import (create_train_state, make_optimizer as jax_optimizer,
                                            make_train_step as jax_train_step)
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.train import checkpoints as CK
from caesar_mrcnn_tpu_torch.train import trainer as TR
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors
from torch_train_fixtures import (jax_config, jax_priorities, jax_state_from, param_errors, seeded_weights,
                                  tiny_config, tiny_dataset)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("data"))


def _batches(dataset, cfg, n):
    it = JaxPipeline(dataset, jax_config(cfg), seed=5).batches()
    return [next(it) for _ in range(n)]


def _port_run(cfg, batches, layers="all"):
    """The port's steps: (losses of each step, final state_dict, optimizer)."""
    model, _ = seeded_weights(cfg)
    opt = TR.make_optimizer(cfg, model, layers)
    step = TR.make_train_step(model, opt, get_anchors(cfg))
    losses = []
    for k, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + k)
        prio = jax_priorities(key, cfg.batch_size, batch["rois"].shape[1], cfg)
        losses.append(step(TR.batch_to_device(batch, "cpu"), priorities=prio))
    return losses, model.state_dict(), opt


def _jax_run(cfg, batches, layers="all"):
    _, tree = seeded_weights(cfg)
    state, tx = create_train_state(jax_config(cfg), tree, layers)
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, get_anchors(cfg))
    losses = []
    for k, batch in enumerate(batches):
        state, jl = jstep(state, batch, jax.random.PRNGKey(100 + k))
        losses.append({n: float(v) for n, v in jl.items()})
    return losses, state


def _check_against_jax(losses, state_dict, jlosses, jstate, start, lr, adam):
    for tl, jl in zip(losses, jlosses, strict=True):
        for name in jl:
            np.testing.assert_allclose(float(tl[name]), jl[name], rtol=1e-4, err_msg=name)
    got = W.state_dict_to_flax({k: v.clone() for k, v in state_dict.items()})["params"]
    for path, size, bad, err, rel in param_errors(got, jax.device_get(jstate.params), start):
        allowed = max(2, int(1e-5 * size)) if adam else 0
        assert bad <= allowed, (path, bad, rel)
        assert bad == 0 or err <= 2 * lr * len(losses), (path, err)


# ------------------------------------------------------------------- remat


@pytest.mark.parametrize("remat", ["backbone", "all"])
def test_remat_step_equals_the_step_without_it(dataset, remat):
    """Three Adam steps: losses, parameters and optimizer state bit for bit
    equal to the same steps without remat."""
    cfg = tiny_config(use_rpn_rois=False, optimizer="adam", learning_rate=1e-4)
    batches = _batches(dataset, cfg, 3)
    ref_losses, ref_state, ref_opt = _port_run(cfg, batches)
    losses, state, opt = _port_run(cfg.replace(train_remat=remat), batches)
    for tl, rl in zip(losses, ref_losses):
        assert all(torch.equal(tl[k], rl[k]) for k in rl)
    assert all(torch.equal(state[k], ref_state[k]) for k in ref_state)
    for kind in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(opt.state[kind], ref_opt.state[kind]))


@pytest.mark.parametrize("remat", ["backbone", "all"])
def test_remat_trajectory_equals_jax(dataset, remat):
    """Three SGD steps against JAX's ``make_train_step`` with the same
    ``train_remat`` (``jax.checkpoint`` around the same regions)."""
    cfg = tiny_config(use_rpn_rois=False, learning_rate=5e-4, train_remat=remat)
    batches = _batches(dataset, cfg, 3)
    losses, state, _ = _port_run(cfg, batches)
    jlosses, jstate = _jax_run(cfg, batches)
    _check_against_jax(losses, state, jlosses, jstate, seeded_weights(cfg)[1]["params"], 5e-4, False)


# ------------------------------------------------------- the bf16 moment


def _optimizer(kind, params, **kw):
    cfg = tiny_config(optimizer=kind, opt_state_dtype="bfloat16", learning_rate=1e-3, learning_momentum=0.9,
                      gradient_clip_norm=1e30, weight_decay=0.0, **kw)
    named = [(f"p{i}", torch.nn.Parameter(torch.from_numpy(p.copy()))) for i, p in enumerate(params)]
    return TR.Optimizer(cfg, named, {n: False for n, _ in named})


CRAFTED_G = np.array([1.0, -0.5, 1e-3, 7.0, 0.1, -3.3e-4, 2.5, 1e-7], np.float32)
CRAFTED_MU = np.array([3.0, 3.0, 1.0, -2.5, 0.3, 1e-3, -7.0, 5e-6], np.float32)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_bf16_moment_update_equals_jitted_optax(kind):
    """One update from a crafted bf16 moment, bit for bit against the
    jitted ``optax.adam(mu_dtype=bf16)`` / ``optax.sgd(accumulator_dtype=
    bf16)``: the stored moment, and for SGD the parameters too (Adam's
    update divides by its own f32 second moment, held within 1e-6).
    ``mu = 3.0`` takes 0.8984375 * 3.0 = 2.6953125, where eager optax rounds
    it to 2.6875 and torch's ``0.9 * mu`` in bf16 gives 2.703125: with
    ``g = 1`` the stored moments are 2.796875, 2.78125 and 2.796875 for
    Adam (0.1 g + ...), and for SGD's trace (g + ...) 3.6953125 stored
    as 3.6875 under all three, while the parameters differ."""
    params = [np.linspace(-1.0, 1.0, 8).astype(np.float32)]
    opt = _optimizer(kind, params)
    key = "mu" if kind == "adam" else "trace"
    mu_bf16 = torch.from_numpy(CRAFTED_MU).bfloat16()
    nu = (CRAFTED_G * CRAFTED_G * 0.5).astype(np.float32)
    with torch.no_grad():
        opt.state[key][0].copy_(mu_bf16)
        if kind == "adam":
            opt.state["nu"][0].copy_(torch.from_numpy(nu))
    opt.count = 3
    assert opt.state[key][0].dtype == torch.bfloat16 and (kind == "sgd" or opt.state["nu"][0].dtype == torch.float32)
    opt.params[0].grad = torch.from_numpy(CRAFTED_G.copy())
    opt.step()

    jmu = jnp.asarray(mu_bf16.float().numpy()).astype(jnp.bfloat16)
    if kind == "adam":
        tx = optax.adam(1e-3, mu_dtype=jnp.bfloat16)
        state = (optax.ScaleByAdamState(count=jnp.asarray(3, jnp.int32), mu=jmu, nu=jnp.asarray(nu)),
                 optax.EmptyState())
    else:
        tx = optax.sgd(1e-3, momentum=0.9, accumulator_dtype=jnp.bfloat16)
        state = (optax.TraceState(trace=jmu), optax.EmptyState())
    updates, new_state = jax.jit(tx.update)(jnp.asarray(CRAFTED_G), state)
    jmoment = np.asarray(getattr(new_state[0], key).astype(jnp.float32))
    got = opt.state[key][0].float().numpy()
    np.testing.assert_array_equal(got, jmoment)
    jparams = np.asarray(optax.apply_updates(jnp.asarray(params[0]), updates))
    if kind == "adam":
        np.testing.assert_allclose(opt.params[0].detach().numpy(), jparams, rtol=1e-6)
        np.testing.assert_array_equal(opt.state["nu"][0].numpy(),
                                      np.asarray(new_state[0].nu))
        assert got[0] == 2.796875
    else:
        np.testing.assert_array_equal(opt.params[0].detach().numpy(), jparams)
        assert got[0] == 3.6875 and jparams[0] == np.float32(params[0][0] - np.float32(1e-3) * np.float32(3.6953125))

    # what the JAX trainer's jitted step keeps and the others do not
    assert float(torch.tensor(3.0).bfloat16().float() * 0.8984375) == 2.6953125
    eager = jnp.asarray(3.0, jnp.bfloat16) * 0.9
    assert float(eager) == 2.6875 and float(torch.tensor(3.0).bfloat16() * 0.9) == 2.703125


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, np.where(x == 0, -133, e - 8))


@pytest.mark.parametrize("optimizer,lr", [("adam", 1e-4), ("sgd", 5e-4)])
def test_bf16_moment_steps_equal_jax(dataset, optimizer, lr):
    """Three steps with ``opt_state_dtype="bfloat16"`` along the port's
    trajectory, each against JAX's step from the port's state before it
    (parameters and the bf16 moment carried across): losses and
    parameters as in ``tests/test_torch_train_steps.py``, and the stored
    moment within one bf16 ulp of JAX's everywhere, over a floor of 1e-3
    of the tensor's largest moment, and more than 99% of its elements bit
    for bit. The floor: the two frameworks' f32 gradients differ element by
    element by up to 5.6e-4 of the tensor's largest gradient (measured in
    ``mrcnn_mask_conv1``, whose Adam moment then differs by 11 ulps at an
    element 80 times smaller than the largest), as in the f32 tests. Along a trajectory one ulp of a moment carried into the
    next step is several ulps of a smaller new one, so the moment is held
    per step."""
    cfg = tiny_config(use_rpn_rois=False, optimizer=optimizer, learning_rate=lr, opt_state_dtype="bfloat16")
    model, tree = seeded_weights(cfg)
    anchors = get_anchors(cfg)
    opt = TR.make_optimizer(cfg, model, "all")
    step = TR.make_train_step(model, opt, anchors)
    tx = jax_optimizer(jax_config(cfg), tree["params"], "all")
    jstep = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, anchors)
    key = "mu" if optimizer == "adam" else "trace"
    bits_equal = total = 0
    for k, batch in enumerate(_batches(dataset, cfg, 3)):
        jkey = jax.random.PRNGKey(100 + k)
        prio = jax_priorities(jkey, cfg.batch_size, batch["rois"].shape[1], cfg)
        before = W.state_dict_to_flax({n: v.clone() for n, v in model.state_dict().items()})["params"]
        jstate, jl = jstep(jax_state_from(model, opt, tx), batch, jkey)
        tl = step(TR.batch_to_device(batch, "cpu"), priorities=prio)
        _check_against_jax([tl], model.state_dict(), [{n: float(v) for n, v in jl.items()}], jstate, before, lr,
                           optimizer == "adam")
        inner = jstate.opt_state[-1][0]
        assert getattr(inner, key)["backbone"]["conv1"]["kernel"].dtype == jnp.bfloat16
        ref = W.flax_to_state_dict({"params": jax.tree_util.tree_map(
            lambda t: np.asarray(t.astype(jnp.float32)), getattr(inner, key))})
        for name, t in zip(opt.names, opt.state[key]):
            assert t.dtype == torch.bfloat16
            got, want = t.float().numpy(), ref[name].numpy()
            bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-3 * np.abs(want).max()
            assert (np.abs(got - want) <= bound).all(), (k, name, float(np.abs(got - want).max()))
            bits_equal += int((got == want).sum())
            total += got.size
    assert bits_equal > 0.99 * total, bits_equal / total
    if optimizer == "adam":
        assert all(t.dtype == torch.float32 for t in opt.state["nu"])


def test_bf16_moment_train_state_round_trips(dataset, tmp_path):
    """``save_train_state``/``load_train_state`` keep the bf16 moment bit
    for bit, and the resumed optimizer's next step equals the original's."""
    cfg = tiny_config(use_rpn_rois=False, optimizer="adam", learning_rate=1e-4, opt_state_dtype="bfloat16",
                      grad_accum_steps=2)
    batches = _batches(dataset, cfg, 3)
    model, _ = seeded_weights(cfg)
    opt = TR.make_optimizer(cfg, model, "all")
    step = TR.make_train_step(model, opt, get_anchors(cfg))
    prio = jax_priorities(jax.random.PRNGKey(0), cfg.batch_size, batches[0]["rois"].shape[1], cfg)
    for batch in batches[:2]:
        step(TR.batch_to_device(batch, "cpu"), priorities=prio)
    step(TR.batch_to_device(batches[2], "cpu"), priorities=prio)  # a micro-step: the running mean is state
    path = CK.save_train_state(str(tmp_path), "x", 1, model, opt, step=3)
    model2, _ = seeded_weights(cfg)
    opt2 = TR.make_optimizer(cfg, model2, "all")
    assert CK.load_train_state(path, model2, opt2) == 3
    for kind in ("mu", "nu", "acc"):
        for a, b in zip(opt.state[kind], opt2.state[kind]):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                                      b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert opt2.state["mu"][0].dtype == torch.bfloat16 and (opt2.count, opt2.mini_step) == (opt.count, opt.mini_step)
    step2 = TR.make_train_step(model2, opt2, get_anchors(cfg))
    for s in (step, step2):
        s(TR.batch_to_device(batches[0], "cpu"), priorities=prio)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), model2.state_dict().values()))


@pytest.mark.parametrize("dtype", ["int8", "complex64", "nonsense"])
def test_unknown_opt_state_dtype_raises(dtype):
    cfg = tiny_config(opt_state_dtype=dtype)
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    with pytest.raises(ValueError, match="opt_state_dtype"):
        TR.make_optimizer(cfg, MaskRCNN(cfg))
