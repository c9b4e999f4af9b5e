"""The port's Keras ``.h5`` import and export (``train/keras_import.py``)
against the JAX package's, on ``tests/test_keras_import.py``'s cases (both
backbones, both caesar class counts), on seeded weights with nonzero biases
and batch norms. Every comparison is exact: both sides move the same f32
arrays."""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

from caesar_mrcnn_tpu.train import keras_import as JK  # noqa: E402
from caesar_mrcnn_tpu_torch import weights as W  # noqa: E402
from caesar_mrcnn_tpu_torch.config import detector_config  # noqa: E402
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: E402
from caesar_mrcnn_tpu_torch.train import checkpoints as CK  # noqa: E402
from caesar_mrcnn_tpu_torch.train import keras_import as TK  # noqa: E402

CASES = [("resnet50", 4), ("resnet101", 6)]
EXCLUDES = [
    ["conv1"],  # gray-input retraining
    ["mrcnn_class_logits", "mrcnn_bbox_fc", "mrcnn_bbox", "mrcnn_mask"],  # the COCO head set
    ["rpn_head", "mrcnn"],  # backbone-only transfer
    ["^batch_stats/"],
]


def _model(arch, nclasses):
    cfg = detector_config(num_classes=nclasses, class_names=tuple(f"c{i}" for i in range(nclasses)),
                          backbone=arch, image_min_dim=128, image_max_dim=128)
    return MaskRCNN(cfg)


_TREES = {}


def _tree(arch, nclasses):
    """A numpy flax tree of the port's model: flax's default kernels from
    seed 3, every bias and batch norm drawn nonzero."""
    if (arch, nclasses) not in _TREES:
        model = _model(arch, nclasses)
        W.init_weights(model, torch.Generator().manual_seed(3))
        rng = np.random.RandomState(3)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                leaf = name.rsplit(".", 1)[1]
                if leaf != "weight":
                    low, high = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(leaf, (-0.1, 0.1))
                    t.copy_(torch.from_numpy(rng.uniform(low, high, tuple(t.shape)).astype(np.float32)))
        _TREES[(arch, nclasses)] = W.state_dict_to_flax(model.state_dict())
    return _TREES[(arch, nclasses)]


def _flax_names(names):
    return {"/".join(W.flax_path(n)) for n in names}


@pytest.mark.parametrize("arch,nclasses", CASES)
def test_jax_written_h5_restores_into_the_port(arch, nclasses, tmp_path):
    """An .h5 written by the JAX package's writer restores into a fresh
    port model equal to ``flax_to_state_dict`` of the same tree, every
    tensor loaded; ``restore_weights`` takes the same path."""
    tree = _tree(arch, nclasses)
    path = str(tmp_path / "w.h5")
    JK.write_keras_h5(JK.variables_to_keras(tree), path)
    want = W.flax_to_state_dict(tree)
    model = _model(arch, nclasses)
    loaded, skipped = CK.restore_weights(model, path)
    assert skipped == [] and len(loaded) == len(want)
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("arch,nclasses", CASES)
def test_port_writer_is_read_back_by_jax(arch, nclasses, tmp_path):
    """The port's ``variables_to_keras`` + ``write_keras_h5`` give the JAX
    package's file: the same layers, weight names and arrays, which JAX's
    reader and ``keras_to_variables`` turn back into the tree."""
    tree = _tree(arch, nclasses)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    TK.write_keras_h5(TK.variables_to_keras(tree), ours)
    JK.write_keras_h5(JK.variables_to_keras(tree), theirs)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        for lname in b.attrs["layer_names"]:
            assert list(a[lname].attrs["weight_names"]) == list(b[lname].attrs["weight_names"])
    got, ref = JK.read_keras_h5(ours), JK.read_keras_h5(theirs)
    assert got.keys() == ref.keys()
    for layer in ref:
        assert got[layer].keys() == ref[layer].keys()
        for w in ref[layer]:
            np.testing.assert_array_equal(got[layer][w], ref[layer][w])
    back, unmapped = JK.keras_to_variables(got)
    assert unmapped == []
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("exclude", EXCLUDES, ids=lambda e: ",".join(e))
def test_exclude_skips_the_same_names_as_jax(exclude, tmp_path):
    tree = _tree("resnet50", 4)
    path = str(tmp_path / "w.h5")
    JK.write_keras_h5(JK.variables_to_keras(tree), path)
    init = jax.tree_util.tree_map(np.zeros_like, tree)
    _, jloaded, jskipped = JK.restore_from_keras_h5(init, path, exclude=exclude)
    model = _model("resnet50", 4)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    loaded, skipped = TK.restore_from_keras_h5(model, path, exclude=exclude)
    assert skipped and _flax_names(skipped) == set(jskipped)
    assert _flax_names(loaded) == set(jloaded)
    want = W.flax_to_state_dict(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(t, fresh[name] if name in skipped else want[name]), name


def test_unmapped_core_layers_raise_as_in_jax(tmp_path):
    """A file whose rpn_*/mrcnn_* layers all fail to map (here under a
    foreign prefix) raises in both packages instead of leaving random
    heads."""
    layers = JK.variables_to_keras(_tree("resnet50", 4))
    renamed = {("x_" + k if ("rpn_" in k or "mrcnn_" in k) else k): v for k, v in layers.items()}
    path = str(tmp_path / "w.h5")
    JK.write_keras_h5(renamed, path)
    with pytest.raises(ValueError, match="mapping failed"):
        JK.restore_from_keras_h5(jax.tree_util.tree_map(np.zeros_like, _tree("resnet50", 4)), path)
    with pytest.raises(ValueError, match="mapping failed"):
        CK.restore_weights(_model("resnet50", 4), path)


def test_deconv_kernel_from_keras_computes_the_flax_transposed_conv(tmp_path):
    """The mask deconv's Keras kernel [kh, kw, out, in] (not symmetric in
    any axis): restored into the port, ``conv_transpose2d`` gives what
    flax's ``ConvTranspose`` gives with the kernel the JAX package's import
    makes of it (axes 2 and 3 swapped), on a non-square input."""
    rng = np.random.RandomState(0)
    kernel = rng.randn(2, 2, 256, 256).astype(np.float32)
    bias = rng.randn(256).astype(np.float32)
    layers = JK.variables_to_keras(_tree("resnet50", 4))
    layers["mrcnn_mask_deconv"] = {"kernel": kernel, "bias": bias}
    path = str(tmp_path / "w.h5")
    JK.write_keras_h5(layers, path)
    model = _model("resnet50", 4)
    CK.restore_weights(model, path)
    x = rng.randn(2, 3, 5, 256).astype(np.float32)
    jtree, _ = JK.keras_to_variables(JK.read_keras_h5(path))
    params = jtree["params"]["mask_head"]["mrcnn_mask_deconv"]
    ref = nn.ConvTranspose(256, (2, 2), strides=(2, 2)).apply({"params": params}, x)
    with torch.no_grad():
        got = model.mask_head.mrcnn_mask_deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
