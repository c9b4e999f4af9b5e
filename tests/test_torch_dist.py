"""The port's data parallelism on the CPU: its communicator and its
data-parallel train step in two real processes (Gloo), each a
``tests/torch_dist_worker.py`` rank with one thread, a free port, an init
timeout and a subprocess timeout, so that a rank that hangs fails the test.

* ``TorchDistComm``: every check of ``tests/dcn_worker.py``, and
  ``get_comm``'s three cases;
* the data-parallel train step (``train/trainer.py`` with a group) on the
  tiny training problem of ``tests/torch_train_fixtures.py`` whose two
  ranks hold different numbers of GT objects (2 against 7), three steps of
  SGD and four micro-steps of Adam with ``grad_accum_steps=2``, given ROIs
  (so that near-tied proposals cannot fork the targets) and the global
  batch's sampling priorities:

  - the losses of every step and the parameters after the last equal the
    one-process port's on the global batch within 1e-5 (relative, and of
    each tensor's scale: ``torch_train_fixtures.param_errors``);
  - they equal the JAX package's ``make_train_step(mesh=make_mesh(2))`` on
    the same weights, batches and priorities within 1e-4, the tolerance of
    ``tests/test_parallel.py``'s sharded trajectory;
  - the two ranks' parameters are bit-equal (rank 1 starts from other
    weights and takes rank 0's by ``broadcast_parameters``).

  Adam divides each gradient element by its own running magnitude
  (``sqrt(nu) + 1e-8``), so an element whose gradient is near zero or
  near 1e-8 turns f32 summation noise into a visible step, up to the
  learning rate in either direction, in either run. So for Adam the
  parameters are held at 1e-4 of each tensor's scale in both comparisons,
  where, as in ``tests/test_torch_grad_accum.py``, elements may exceed it,
  each by no more than 2 * learning rate * updates, and at least 3 in a
  tensor (the stem's three input channels all see the one mono image, so
  one element's noise shows three times); here up to 1e-4 of a tensor's
  elements, not 1e-5: this batch's seven GT objects leave more mask-head
  elements with a gradient near zero (measured on the CPU: 32 of the
  589,824 of ``mrcnn_mask_conv1`` between the one-process port and JAX,
  27 between the two port runs; at 1e-5 of the scale, 1,039 between the
  two port runs, while their losses agree within 4e-7; the second
  update's gradients are taken at these parameters, so even Adam's first
  moment then differs by up to 6e-4 of a mask-head tensor's scale). SGD,
  which has no such division, holds the gradients: its parameters are
  held at 1e-5 with no exception.

  One more case draws the priorities from a generator on every rank (the
  RPN's proposals and NMS run) and holds the losses to the one-process
  step with the same generator, within 1e-5;
* the negative control: averaging the ranks' own masked means (DDP's
  way) differs from the global loss by more than 1e-3 on that batch.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.data.generator import TrainingPipeline as JaxPipeline
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from caesar_mrcnn_tpu.train.trainer import create_train_state, make_train_step as jax_train_step
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset
from caesar_mrcnn_tpu_torch.parallel import dist as D
from caesar_mrcnn_tpu_torch.parallel import mesh as M
from caesar_mrcnn_tpu_torch.train import trainer as TR
from caesar_mrcnn_tpu_torch.utils import fits as F
from caesar_mrcnn_tpu_torch.utils.anchors import get_anchors
from torch_train_fixtures import jax_config, jax_priorities, param_errors, seeded_weights, tiny_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def run_workers(case, directory, *args, world=2, timeout=180):
    """Run ``world`` ranks of the worker's ``case``; each must exit 0 and
    print its OK line. Returns their outputs."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["OMP_NUM_THREADS"] = "1"
    port = D.free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(port), str(r), str(world), str(directory),
                               *args], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"{case.upper()}_{r}_OK" in out, f"rank {r}:\n{out[-4000:]}"
    return outs


# ------------------------------------------------------------ communicator


def test_torch_dist_comm_two_processes(tmp_path):
    """TorchDistComm with two real processes: ``get_comm`` gives it once
    the group is initialized; unequal objects, a chunked exchange of
    40,000 against 80,000 rows, gather to rank 0, barrier."""
    run_workers("comm", tmp_path)


def test_get_comm_without_a_group(monkeypatch):
    """One process: SerialComm. A launcher's WORLD_SIZE above 1 without
    an initialized group: raises, so that no rank writes a catalog of its
    own tiles alone."""
    for name in LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)
    assert isinstance(D.get_comm(), D.SerialComm)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert isinstance(D.get_comm(), D.SerialComm)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no torch.distributed group is initialized"):
        D.get_comm()
    with pytest.raises(RuntimeError, match="no launcher variables"):
        monkeypatch.delenv("WORLD_SIZE")
        D.init_from_env("cpu")


def test_backend_rule_and_rank_devices(monkeypatch):
    """NCCL when every rank of the host has a card of its own; Gloo on the
    CPU and when ranks share a card. A rank's device is
    ``cuda:(LOCAL_RANK % cards)``."""
    assert D.choose_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert D.choose_backend("cuda", 4) == "nccl"
    assert D.choose_backend("cuda:1", 1) == "nccl"
    assert D.choose_backend("cuda", 8) == "gloo"
    assert [D.rank_device("cuda", r) for r in (0, 3, 5)] == [torch.device("cuda", i) for i in (0, 3, 1)]
    assert D.rank_device("cpu", 3) == torch.device("cpu")


def test_rows_devices_and_buckets(monkeypatch):
    """The contiguous per-device rows of ``shard_batch``'s split; the
    first n cards, fewer where fewer exist, and n CPU entries; flat buckets
    of one dtype, each within its byte budget."""
    assert [M.shard_rows(8, 2, i) for i in (0, 1)] == [slice(0, 4), slice(4, 8)]
    with pytest.raises(ValueError, match="not divisible"):
        M.shard_rows(6, 4, 0)
    batch = {"a": np.arange(12).reshape(6, 2), "b": np.arange(6)}
    np.testing.assert_array_equal(M.shard_batch(batch, 3, 1)["a"], [[4, 5], [6, 7]])
    assert M.local_devices("cpu", 3) == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert M.local_devices("cuda", 2) == [torch.device("cuda", 0)]
    ts = [torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.float64), torch.zeros(100), torch.zeros(3)]
    assert D.flat_buckets(ts, bucket_bytes=160) == [[0, 1], [2], [3], [4]]


# ---------------------------------------------------------------- training

# objects per image: images 0 and 1 (rank 0) hold 1 each, images 2 and 3
# (rank 1) 4 and 3
OBJECTS = (1, 1, 4, 3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("data"))


def write_dataset(root):
    """Four 64^2 FITS images with OBJECTS[i] square sources each (one FITS
    mask per source), in SourceDataset's json layout."""
    ds = SourceDataset()
    ds.set_class_dict({"sidelobe": 1, "source": 2, "galaxy": 3})
    rng = np.random.RandomState(0)
    for i, n in enumerate(OBJECTS):
        img = rng.normal(0, 0.02, (64, 64)).astype(np.float32)
        objs = []
        for j in range(n):
            y, x = 4 + 15 * j, 6 + 9 * i + 3 * j
            img[y:y + 11, x:x + 11] += 5.0
            mask = np.zeros((64, 64), np.float32)
            mask[y:y + 11, x:x + 11] = 1.0
            F.write_fits(mask, str(root / f"mask{i}_{j}.fits"))
            objs.append({"mask": str(root / f"mask{i}_{j}.fits"), "class": ("source", "galaxy")[j % 2]})
        F.write_fits(img, str(root / f"img{i}.fits"))
        (root / f"img{i}.json").write_text(json.dumps({"img": str(root / f"img{i}.fits"), "objs": objs}))
        assert ds.load_data_from_json_file(str(root / f"img{i}.json")) == 0
    ds.prepare()
    return ds


def _config(**kw):
    """Global batch 4 over two ranks (two rows each); given ROIs."""
    return tiny_config(use_rpn_rois=False, images_per_device=2, num_devices=2, **kw)


def _batches(dataset, cfg, n):
    it = JaxPipeline(dataset, jax_config(cfg), shuffle=False, seed=5).batches()
    return [next(it) for _ in range(n)]


def _one_process(cfg, batches, priorities, generator=None):
    """The port's step on the global batches in one process: (losses of
    each step, parameters after the last, as a flax tree, optimizer
    state)."""
    model, _ = seeded_weights(cfg)
    optimizer = TR.make_optimizer(cfg, model, "all")
    step = TR.make_train_step(model, optimizer, get_anchors(cfg))
    losses = []
    for k, batch in enumerate(batches):
        kw = {"generator": generator} if priorities is None else {"priorities": priorities[k]}
        losses.append({n: float(v) for n, v in step(TR.batch_to_device(batch, "cpu"), **kw).items()})
    return losses, W.state_dict_to_flax(model.state_dict())["params"], optimizer.state_dict()


def _two_ranks(tmp_path, cfg, batches, priorities, seed=0):
    """The data-parallel step in two worker processes: (rank 0's losses,
    rank 0's parameters as a flax tree, the ranks' saved results)."""
    model, _ = seeded_weights(cfg)
    torch.save({"config": cfg, "state": model.state_dict(), "batches": batches, "priorities": priorities,
                "seed": seed}, tmp_path / "train_inputs.pt")
    run_workers("train", tmp_path)
    ranks = [torch.load(tmp_path / f"train_rank{r}.pt", weights_only=False) for r in (0, 1)]
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"]), \
        "the ranks' parameters differ"
    return ranks[0]["losses"], W.state_dict_to_flax(ranks[0]["state"])["params"], ranks


def _jax_mesh(cfg, batches, keys):
    """The JAX package's train step sharded over a 2-device data mesh."""
    _, tree = seeded_weights(cfg)
    mesh = make_mesh(n_devices=2)
    state, tx = create_train_state(jax_config(cfg), tree, "all")
    step = jax_train_step(JaxMaskRCNN(jax_config(cfg)), tx, get_anchors(cfg), mesh=mesh)
    state = replicate_tree(state, mesh)
    losses = []
    with mesh:
        for batch, key in zip(batches, keys):
            state, jl = step(state, shard_batch(batch, mesh), key)
            losses.append({n: float(v) for n, v in jl.items()})
    return losses, jax.device_get(state.params)


def _check(got_losses, got, ref_losses, ref, start, tol, adam_lr=None, updates=0):
    """Losses within ``tol`` relative; parameters within ``tol`` of each
    tensor's scale, or 1e-4 with Adam's exceptions (module docstring)."""
    for step_got, step_ref in zip(got_losses, ref_losses, strict=True):
        assert set(step_got) == set(step_ref)
        for name in step_ref:
            np.testing.assert_allclose(step_got[name], step_ref[name], rtol=tol, err_msg=name)
    for path, size, bad, err, rel in param_errors(got, ref, start, tol=1e-4 if adam_lr else tol):
        allowed = max(3, int(1e-4 * size)) if adam_lr else 0
        assert bad <= allowed, (path, bad, rel)
        assert bad == 0 or err <= 2 * adam_lr * updates, (path, err)


@pytest.mark.parametrize("optimizer,accum,lr,steps", [("sgd", 1, 5e-4, 3), ("adam", 2, 1e-4, 4)])
def test_dp_train_equals_one_process_and_jax_mesh(dataset, tmp_path, optimizer, accum, lr, steps):
    cfg = _config(optimizer=optimizer, learning_rate=lr, grad_accum_steps=accum)
    batches = _batches(dataset, cfg, steps)
    # rank 0's rows hold 2 GT objects, rank 1's 7
    assert [(b["gt_class_ids"][:2] > 0).sum() for b in batches[:1]] == [2]
    assert [(b["gt_class_ids"][2:] > 0).sum() for b in batches[:1]] == [7]
    keys = [jax.random.PRNGKey(100 + k) for k in range(steps)]
    priorities = [jax_priorities(key, cfg.batch_size, b["rois"].shape[1], cfg) for key, b in zip(keys, batches)]
    start = seeded_weights(cfg)[1]["params"]

    dp_losses, dp, _ = _two_ranks(tmp_path, cfg, batches, priorities)
    one_losses, one, _ = _one_process(cfg, batches, priorities)
    adam = lr if optimizer == "adam" else None
    updates = steps // accum
    _check(dp_losses, dp, one_losses, one, start, 1e-5, adam, updates)
    jax_losses, jax_params = _jax_mesh(cfg, batches, keys)
    _check(dp_losses, dp, jax_losses, jax_params, start, 1e-4, adam, updates)
    assert dp_losses[0]["mrcnn_mask_loss"] > 0 and dp_losses[0]["mrcnn_class_loss"] > 0


def test_dp_train_draws_the_global_priorities(dataset, tmp_path):
    """Without given priorities every rank draws the global batch's from
    the same generator state and keeps its rows: the RPN path (proposals,
    NMS) with the losses of the one-process step that draws them."""
    cfg = tiny_config(images_per_device=2, num_devices=2, learning_rate=5e-4)
    batches = _batches(dataset, cfg, 2)
    dp_losses, _, _ = _two_ranks(tmp_path, cfg, batches, None, seed=11)
    one_losses, _, _ = _one_process(cfg, batches, None, torch.Generator().manual_seed(11))
    for got, ref in zip(dp_losses, one_losses, strict=True):
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, err_msg=name)


def test_per_rank_means_differ_from_the_global_loss(dataset):
    """The negative control: the mean of the two ranks' own losses (each a
    masked mean over its own rows, DDP's way) is not the global batch's
    loss on this batch, so the tests above can see the hazard."""
    cfg = _config()
    batch = _batches(dataset, cfg, 1)[0]
    priorities = jax_priorities(jax.random.PRNGKey(100), cfg.batch_size, batch["rois"].shape[1], cfg)
    model, _ = seeded_weights(cfg)
    step = TR.make_eval_step(model, get_anchors(cfg))
    whole = float(step(TR.batch_to_device(batch, "cpu"), priorities=priorities)["total_loss"])
    own = []
    for r in (0, 1):
        rows = M.shard_rows(cfg.batch_size, 2, r)
        part = TR.batch_to_device(M.shard_batch(batch, 2, r), "cpu")
        own.append(float(step(part, priorities=tuple(p[rows] for p in priorities))["total_loss"]))
    assert abs(np.mean(own) - whole) > 1e-3, (own, whole)


def test_every_rank_makes_rank_0s_split(tmp_path, monkeypatch):
    """``train --datalist`` alone splits the list at random: under data
    parallelism every rank makes rank 0's split (its seed, through the
    communicator), and only rank 0 writes ``train.dat``/``crossval.dat``
    to the working directory."""
    from caesar_mrcnn_tpu_torch.cli import run as cli

    class Comm:
        size = 2

        def __init__(self, rank):
            self.rank = rank

        def allgather(self, obj):
            return [12345, obj]  # rank 0's draw first

    (tmp_path / "list.dat").write_text("\n".join(f"img{i}.fits,mask{i}.fits,source" for i in range(20)))
    args = cli.parse_args(["train", "--datalist", str(tmp_path / "list.dat")])
    monkeypatch.setattr(cli, "_load_train_val", lambda args, cfg, t, v: (Path(t).read_text(), Path(v).read_text()))
    splits = {}
    for rank in (1, 0):
        monkeypatch.chdir(tmp_path)
        splits[rank] = cli.create_train_val_datasets(args, None, Comm(rank))
        assert sorted(os.listdir(tmp_path)) == (["crossval.dat", "list.dat", "train.dat"] if rank == 0 else ["list.dat"])
    assert splits[0] == splits[1] and len(splits[0][1].splitlines()) == 2
    assert splits[0] != cli.create_train_val_datasets(args, None, None)  # one process: its own random split
