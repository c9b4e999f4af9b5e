"""The port's eval CLIs (``cli/eval_voc.py``, ``cli/eval_map.py``) and model
introspection (``models/introspection.py``) against the JAX package's, on
the CPU, beside ``tests/test_misc.py``'s cases of the originals:

* ``eval_voc``: the same ``results.txt`` and standard output, byte for
  byte, on seeded box tables; no PNG, and a warning logged instead unless
  ``--noplot`` is given (the JAX CLI draws one per class);
* ``eval_map``: the same standard output; ``--plot`` refused before any
  file is read;
* introspection: ``count_params`` equal exactly, in total and per
  top-level module (port names mapped through ``weights.flax_path``);
  ``get_trainable_layers`` the same set for every stage selector;
  ``run_graph``'s P2-P6 and the FPN's own convolutions within 1e-4 of the
  JAX ``run_graph``'s on one seeded 0..255 image, relative to each
  tensor's largest value (the random weights give values in the
  hundreds), and its hooks removed after.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu.cli import eval_map as jeval_map
from caesar_mrcnn_tpu.cli import eval_voc as jeval_voc
from caesar_mrcnn_tpu.config import detector_config as jdetector_config
from caesar_mrcnn_tpu.evalmetrics.voc import BBox, write_padilla_dirs
from caesar_mrcnn_tpu.models import introspection as jintro
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.cli import eval_map as teval_map
from caesar_mrcnn_tpu_torch.cli import eval_voc as teval_voc
from caesar_mrcnn_tpu_torch.config import detector_config as tdetector_config
from caesar_mrcnn_tpu_torch.models import introspection as tintro
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

torch.set_num_threads(2)

# ------------------------------------------------------------------ eval CLIs


def _voc_dirs(root, seed):
    """Seeded Padilla txt dirs: 3 images, 3 classes, boxes jittered and
    some missed or spurious."""
    rng = np.random.RandomState(seed)
    names = ("sidelobe", "source", "galaxy")
    gts, dets = [], []
    for image in ("a", "b", "c"):
        for i in range(5):
            x, y = rng.randint(0, 90, 2)
            box = (x, y, x + rng.randint(4, 30), y + rng.randint(4, 30))
            cls = names[rng.randint(3)]
            gts.append(BBox(image, cls, box))
            if rng.rand() < 0.8:
                dets.append(BBox(image, cls, tuple(v + rng.randint(-3, 4) for v in box), float(rng.rand())))
            if rng.rand() < 0.3:
                dets.append(BBox(image, names[rng.randint(3)], box, float(rng.rand())))
    write_padilla_dirs(gts, dets, str(root / "gt"), str(root / "det"))


@pytest.mark.parametrize("args", [[], ["-t", "0.3", "-m", "eleven_point"], ["--noplot"]],
                         ids=["defaults", "threshold and eleven point", "noplot"])
def test_eval_voc_equals_jax(args, tmp_path, capsys, caplog, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _voc_dirs(tmp_path, 3)
    out = {}
    for name, mod in (("jax", jeval_voc), ("torch", teval_voc)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="caesar_mrcnn_tpu_torch"):
            assert mod.main(["-gt", "gt", "-det", "det", "-sp", name] + args) == 0
        warned = [r.getMessage() for r in caplog.records if r.name.startswith("caesar_mrcnn_tpu_torch")]
        out[name] = ((tmp_path / name / "results.txt").read_bytes(), capsys.readouterr().out, warned)
    assert out["torch"][:2] == out["jax"][:2]
    assert b"mAP: " in out["torch"][0]
    pngs = {name: sorted(f for f in os.listdir(tmp_path / name) if f.endswith(".png")) for name in out}
    assert pngs["torch"] == []
    if "--noplot" in args:
        assert pngs["jax"] == [] and out["torch"][2] == []
    else:
        assert pngs["jax"]  # the JAX CLI draws each class's curve
        assert len(out["torch"][2]) == 1 and "A16c" in out["torch"][2][0]


@pytest.mark.parametrize("args", [[], ["--iou_start", "0.3", "--iou_end", "0.9", "--iou_step", "0.1"]],
                         ids=["defaults", "iou sweep"])
def test_eval_map_equals_jax(args, tmp_path, capsys):
    rng = np.random.RandomState(5)
    gt, pred = {}, {}
    for image in ("a", "b", "c", "d"):
        xy = rng.randint(0, 90, (6, 2))
        boxes = np.c_[xy, xy + rng.randint(3, 30, (6, 2))]
        gt[image] = boxes[:4].tolist()
        pred[image] = {"boxes": (boxes + rng.randint(-2, 3, boxes.shape)).tolist(), "scores": rng.rand(6).tolist()}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "pred.json").write_text(json.dumps(pred))
    argv = ["--gt", str(tmp_path / "gt.json"), "--pred", str(tmp_path / "pred.json")] + args
    printed = []
    for mod in (jeval_map, teval_map):
        assert mod.main(argv) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "mAP: " in printed[1]


def test_eval_map_plot_refused_before_any_read(tmp_path, monkeypatch):
    """``--plot`` is refused before the json files are read (neither
    exists); the JAX CLI draws there."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="A16c"):
        teval_map.main(["--gt", "missing_gt.json", "--pred", "missing_pred.json", "--plot", "pr.png"])
    assert os.listdir(tmp_path) == []
    assert jeval_map.parse_args(["--plot", "pr.png"]).plot == "pr.png"


# -------------------------------------------------------------- introspection

# tests/test_misc.py's introspection config
INTRO_KW = dict(backbone="custom", image_min_dim=64, image_max_dim=64, num_classes=2, class_names=("bkg", "source"),
                rpn_anchor_scales=(8, 16, 32, 64, 128), compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's MaskRCNN with the same weights)."""
    cfg = jdetector_config(**INTRO_KW)
    model = JaxMaskRCNN(cfg)
    dummy = jnp.zeros((1,) + cfg.image_shape, jnp.float32)
    # init_model's variables, jitted (eager init takes half a minute)
    variables = jax.jit(lambda key: model.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.array, variables)
    port = MaskRCNN(tdetector_config(**INTRO_KW))
    port.load_state_dict(W.flax_to_state_dict(variables))
    return model, variables, port


def test_count_params_equals_jax(models):
    _, variables, port = models
    got, ref = tintro.count_params(port), jintro.count_params(variables["params"])
    assert got["total"] == ref["total"] > 1e5
    by_flax_top = {}
    for name, p in port.named_parameters():
        top = W.flax_path(name)[1].split("/", 1)[0]
        by_flax_top[top] = by_flax_top.get(top, 0) + p.numel()
    assert by_flax_top == {k: v for k, v in ref.items() if k != "total"}
    assert {k: v for k, v in got.items() if k != "total"} == by_flax_top


@pytest.mark.parametrize("layers", ["heads", "3+", "4+", "5+", "all"])
def test_get_trainable_layers_equals_jax(layers, models):
    _, variables, port = models
    got = tintro.get_trainable_layers(port, layers)
    assert got == sorted(got)
    assert {W.flax_path(name)[1] for name in got} == set(jintro.get_trainable_layers(variables["params"], layers))
    if layers == "heads":
        assert got and not any(name.startswith("backbone.res2") for name in got)


def _assert_close(got, ref, what):
    """An NCHW port tensor against an NHWC JAX array, within 1e-4 of the
    array's largest absolute value."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                               err_msg=what)


def test_run_graph_equals_jax(models):
    model, variables, port = models
    image = np.random.RandomState(0).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    ref = jintro.run_graph(model, variables, jnp.asarray(image))
    got = tintro.run_graph(port, image)
    assert len(got["outputs"]) == len(ref["outputs"]) == 5
    for p, (g, r) in enumerate(zip(got["outputs"], ref["outputs"]), start=2):
        _assert_close(g, r, f"P{p}")
    # the FPN's own layers, by the flax path of each port module
    fpn = {name: t for name, t in got["intermediates"].items() if name.startswith("fpn.")}
    assert len(fpn) >= 8
    for name, t in fpn.items():
        module, call = name.split("[", 1)
        r = ref["intermediates"][module.replace(".", "/") + "/__call__[" + call]
        _assert_close(t, r, name)
    # every submodule's output is captured, and the filter selects by name
    assert "backbone.conv1[0]" in got["intermediates"] and "fpn[0][4]" in got["intermediates"]
    only = tintro.run_graph(port, image, filter_regex=r"^fpn\.fpn_p\d")
    assert sorted(only["intermediates"]) == [f"fpn.fpn_p{i}[0]" for i in (2, 3, 4, 5)]
    assert all(not m._forward_hooks for m in port.modules())
