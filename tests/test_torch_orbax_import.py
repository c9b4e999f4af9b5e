"""The orbax weight import (``tools/orbax_to_pt.py``): a weights checkpoint
that the JAX package writes (``caesar_mrcnn_tpu/train/checkpoints.py``)
converted in a subprocess on the JAX CPU and restored into the port as the
same tree, bit for bit; a train-state directory refused; the port's own
error on a directory naming the tool. The tool runs where jax and orbax
are installed, outside the port, which imports neither
(``tests/test_torch_no_jax.py`` exempts it by name)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.train import checkpoints as JCK
from caesar_mrcnn_tpu.train.trainer import create_train_state
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from caesar_mrcnn_tpu_torch.train import checkpoints as CK
from torch_train_fixtures import jax_config, seeded_weights, tiny_config

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "orbax_to_pt.py"


def _tool(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(TOOL), *map(str, args)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-written weights checkpoint of the tiny training config: seeded
    kernels, and biases, scales and running statistics drawn nonzero."""
    cfg = tiny_config()
    _, tree = seeded_weights(cfg, seed=3)
    root = tmp_path_factory.mktemp("orbax")
    path = JCK.save_checkpoint(str(root / "run"), "RG-Dataset", 7, tree)
    return cfg, tree, path


def test_orbax_weights_reach_the_port_as_the_same_tree(saved, tmp_path):
    cfg, tree, path = saved
    assert os.path.basename(path) == "mask_rcnn_rg-dataset_0007"
    assert np.abs(tree["batch_stats"]["backbone"]["bn_conv1"]["BatchNorm_0"]["mean"]).max() > 0
    proc = _tool(path, "--out", tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    pt = proc.stdout.strip().splitlines()[-1]
    assert pt == str(tmp_path / "mask_rcnn_rg-dataset_0007.pt") and CK.find_last(str(tmp_path)) == pt
    assert CK.epoch_from_path(pt) == 7

    model = MaskRCNN(cfg)
    loaded, skipped = CK.restore_weights(model, pt)
    assert not skipped and len(loaded) == len(model.state_dict())
    got = W.state_dict_to_flax(model.state_dict())
    ref = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (p, g), (_, r) in zip(got_leaves, ref_leaves):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(r)), jax.tree_util.keystr(p)


def test_the_tool_names_the_pt_after_the_directory(saved, tmp_path):
    """Beside the checkpoint by default, named after it; a directory not
    named as the JAX package names its weights is refused."""
    cfg, tree, path = saved
    JCK.save_checkpoint(str(tmp_path), "x", 1, tree)
    proc = _tool(tmp_path / "mask_rcnn_x_0001")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == str(tmp_path / "mask_rcnn_x_0001.pt")
    stored = CK.load_checkpoint(str(tmp_path / "mask_rcnn_x_0001.pt"))
    assert all(torch.equal(stored[k], v) for k, v in W.flax_to_state_dict(tree).items())
    other = tmp_path / "exported"
    os.rename(tmp_path / "mask_rcnn_x_0001", other)
    refused = _tool(other)
    assert refused.returncode != 0 and "mask_rcnn_<name>_NNNN" in refused.stderr
    assert not list(tmp_path.glob("exported*.pt"))


def test_a_train_state_is_refused(saved, tmp_path):
    cfg, tree, _ = saved
    state, _ = create_train_state(jax_config(cfg), jax.tree_util.tree_map(jnp.asarray, tree), "all")
    path = JCK.save_train_state(str(tmp_path), "x", 1, state)
    assert path.endswith("_state")
    proc = _tool(path)
    assert proc.returncode != 0 and "converts weights" in proc.stderr
    assert not list(tmp_path.glob("*.pt"))


def test_the_ports_directory_error_names_the_tool(saved):
    cfg, _, path = saved
    with pytest.raises(ValueError, match=r"python3 tools/orbax_to_pt\.py .*mask_rcnn_rg-dataset_0007"):
        CK.restore_weights(MaskRCNN(cfg), path)
