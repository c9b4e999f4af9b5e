"""The port's CLI (``caesar_mrcnn_tpu_torch.cli.run``) against the JAX
package's (``caesar_mrcnn_tpu.cli.run``), on the CPU at small sizes:

* the same flags and defaults, and ``build_config`` equal field by field,
  on a table of argv lists;
* ``detect`` (a serial window, square tiles, rectangular tiles, and
  square tiles with ``--serving``, the int8 graph) and ``test`` (float and
  ``--serving``) through both CLIs on the same weights: ``PRNGKey(0)``'s
  variables with ``testing.pin_heads``, written once as the JAX package's
  orbax checkpoint and once as the port's ``.pt``. Both configs are set to
  f32 (the CLI has no flag for it), so that the two frameworks' bf16
  roundings cannot reorder proposals; with ``--serving``, the port's int8
  calibration is the JAX package's (``jax_calibration``). The catalogs and
  DS9 files, and the tester's tables and dumps, must agree: every value
  equal but the scores, within 1e-5;
* ``train`` (gradient accumulation, validation) -> resume -> ``test`` ->
  ``detect`` -> ``export`` (then a ``ServingDetector`` on the artifact) on
  the port alone, as ``tests/test_cli_e2e.py`` runs the JAX CLI;
* what the port refuses, each beside what the JAX CLI does with it.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.cli import run as jcli
from caesar_mrcnn_tpu.models import heads_int8 as jheads_int8
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.train import checkpoints as JCK
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch.cli import run as tcli
from caesar_mrcnn_tpu_torch.inference.export import ServingDetector
from caesar_mrcnn_tpu_torch.models import heads_int8 as theads_int8
from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from caesar_mrcnn_tpu_torch.testing import pin_heads
from caesar_mrcnn_tpu_torch.train import checkpoints as TCK
from caesar_mrcnn_tpu_torch.utils import fits as F
from test_cli_e2e import TINY, workdir  # noqa: F401 - workdir is a fixture
from test_torch_sfinder import DETECT_KW, _assert_same_catalogs, _floats, _rows, _shape, _write_dataset

torch.set_num_threads(2)

CPU = ["--device", "cpu"]

# ------------------------------------------------------------------ config

CONFIG_ARGVS = {
    "defaults": ["train"],
    "tiny": ["train"] + TINY,
    "grayimg": ["train", "--grayimg", "--datalist", "list.dat"],
    "serving without int8": ["detect", "--image", "x.fits", "--serving", "--quant_mode", "none"],
    "serving alone": ["detect", "--image", "x.fits", "--serving"],
    "per-class thresholds": ["test", "--scoreThrPerClass", "sidelobe=0.8,galaxy=0.5", "--scoreThr", "0.3"],
    "rectangular tiles": ["detect", "--image", "x.fits", "--split_img_in_tiles", "--tile_xsize", "192",
                          "--tile_ysize", "128", "--tile_xstep", "0.5"],
    "biascontrast": ["test", "--biascontrast", "--bias", "0.3", "--contrast", "2.0", "--no_zscale",
                     "--zscale_contrasts", "0.1,0.2,0.3"],
}


@pytest.mark.parametrize("case", list(CONFIG_ARGVS))
def test_flags_and_config_equal_jax(case):
    argv = CONFIG_ARGVS[case]
    got, ref = tcli.parse_args(argv), jcli.parse_args(argv)
    flags = vars(got)
    assert flags.pop("device") == "cuda"
    assert flags == vars(ref)
    assert dataclasses.asdict(tcli.build_config(got)) == dataclasses.asdict(jcli.build_config(ref))


# --------------------------------------------------- detect and test vs JAX

# the detector of tests/test_torch_sfinder.py, as CLI flags
SMALL = ["--backbone", "custom", "--imgsize", "128", "--pre_nms_limit", "256", "--post_nms_rois_inference", "64",
         "--detection_max_instances", "16", "--nimg_per_gpu", "1"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(port .pt, JAX orbax directory) of the same pinned weights."""
    root = tmp_path_factory.mktemp("weights")
    jcfg = jconfig.inference_config(jconfig.detector_config(**DETECT_KW))
    jmodel = JaxMaskRCNN(jcfg)
    dummy = jnp.zeros((1,) + jcfg.image_shape, jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    model = MaskRCNN(jcfg)
    model.load_state_dict(W.flax_to_state_dict(jax.tree_util.tree_map(np.array, variables)))
    pin_heads(model)
    name = jcfg.name
    pt = TCK.save_checkpoint(str(root / "torch"), name, 1, model)
    orbax = JCK.save_checkpoint(str(root / "jax"), name, 1, W.state_dict_to_flax(model.state_dict()))
    return pt, orbax


@pytest.fixture()
def f32(monkeypatch):
    for cli in (tcli, jcli):
        build = cli.build_config
        monkeypatch.setattr(cli, "build_config", lambda args, _b=build: _b(args).replace(compute_dtype="float32"))


def _both(tmp_path, monkeypatch, weights, argv):
    """Run ``argv`` through both CLIs, each in a directory of its own (the
    DS9 file goes to the working directory); returns the directories."""
    dirs = {}
    for name, cli, extra, w in (("jax", jcli, [], weights[1]), ("torch", tcli, CPU, weights[0])):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        monkeypatch.chdir(dirs[name])
        assert cli.main(argv + SMALL + extra + ["--weights", w, "--logs", str(dirs[name] / "logs")]) == 0
    return dirs


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    """384^2 of noise with two bright blocks, one straddling x = 256."""
    rng = np.random.RandomState(0)
    data = rng.normal(0.0, 0.01, (384, 384)).astype(np.float32)
    data[20:40, 20:40] += 10.0
    data[158:178, 246:266] += 10.0
    path = str(tmp_path_factory.mktemp("mosaic") / "mosaic.fits")
    F.write_fits(data, path, header={"CDELT1": -2.8e-4, "CDELT2": 2.8e-4, "BMAJ": 1.5e-3, "BMIN": 1.2e-3})
    return path


DETECT_CASES = {
    "serial window": ["--xmin", "10", "--xmax", "300", "--ymin", "5", "--ymax", "250"],
    "square tiles": ["--split_img_in_tiles", "--tile_xsize", "128", "--tile_ysize", "128"],
    "rectangular tiles": ["--split_img_in_tiles", "--tile_xsize", "192", "--tile_ysize", "128"],
    # the tiled path draws nothing: both CLIs ignore the overlay's path there
    "square tiles, overlay path ignored": ["--split_img_in_tiles", "--tile_xsize", "128", "--tile_ysize", "128",
                                           "--detect_outfile", "overlay.png"],
}


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_detect_equals_jax_cli(case, weights, mosaic, f32, tmp_path, monkeypatch):
    argv = ["detect", "--image", mosaic, "--detect_outfile_json", "catalog.json"] + DETECT_CASES[case]
    dirs = _both(tmp_path, monkeypatch, weights, argv)
    out = {name: (json.loads((d / "catalog.json").read_text()), (d / "ds9_mosaic.reg").read_bytes())
           for name, d in dirs.items()}
    _assert_same_catalogs(out, score_atol=1e-5)
    assert not any((d / "overlay.png").exists() for d in dirs.values())


@pytest.fixture()
def jax_calibration(monkeypatch):
    """The port's int8 calibration computed by the JAX package's
    ``calibrate_detect`` on the same inputs and weights: the two
    calibrations sum their f32 convolutions in another order, their scales
    differ in the last bits (held within 1e-5 by
    ``tests/test_torch_quant.py``), and a scale one ulp off moves a few
    quantized values by a step, enough to change a cross-tile merge. With
    one set of scales, the rest of the int8 path is compared exactly."""
    def calibrate(model, folded, molded, image_metas, anchors, batch=None):
        jcfg = jconfig.Config(**dataclasses.asdict(model.config))
        variables = W.state_dict_to_flax(model.state_dict())
        arrays = (torch.as_tensor(a).cpu().numpy() for a in (molded, image_metas, anchors))
        return jheads_int8.calibrate_detect(JaxMaskRCNN(jcfg), variables, jcfg, folded, *arrays, batch=batch)

    monkeypatch.setattr(theads_int8, "calibrate_detect", calibrate)


def test_detect_serving_equals_jax_cli(weights, mosaic, f32, jax_calibration, tmp_path, monkeypatch):
    """``--serving``: both CLIs calibrate the int8 graph on their first tile
    batch and detect with it (the small proposal budget of ``SMALL`` wins
    over the preset's, as explicit flags do)."""
    argv = ["detect", "--image", mosaic, "--detect_outfile_json", "catalog.json", "--serving"]
    dirs = _both(tmp_path, monkeypatch, weights, argv + DETECT_CASES["square tiles"])
    out = {name: (json.loads((d / "catalog.json").read_text()), (d / "ds9_mosaic.reg").read_bytes())
           for name, d in dirs.items()}
    _assert_same_catalogs(out, score_atol=1e-5)


def test_test_mode_equals_jax_cli(weights, f32, tmp_path, monkeypatch):
    _assert_same_tester_outputs(tmp_path, monkeypatch, weights, [])


def test_test_mode_serving_equals_jax_cli(weights, f32, jax_calibration, tmp_path, monkeypatch):
    """``test --serving``: the int8 graph, calibrated on the first batch."""
    _assert_same_tester_outputs(tmp_path, monkeypatch, weights, ["--serving"])


def _assert_same_tester_outputs(tmp_path, monkeypatch, weights, extra):
    listfile = _write_dataset(tmp_path)
    dirs = _both(tmp_path, monkeypatch, weights, ["test", "--datalist", listfile] + extra)
    out = {name: d / "logs" for name, d in dirs.items()}
    for name in ("completeness.csv", "reliability.csv"):
        got, ref = _rows(out["torch"] / name), _rows(out["jax"] / name)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            for k in r:
                if k == "score":
                    assert float(g[k]) == pytest.approx(float(r[k]), abs=1e-5)
                else:
                    assert g[k] == r[k], (name, k)
    for name in ("map_summary.json", "metric_computation_input.json", "predicted_boxes.json"):
        got, ref = json.loads((out["torch"] / name).read_text()), json.loads((out["jax"] / name).read_text())
        np.testing.assert_allclose(_floats(got), _floats(ref), rtol=0, atol=1e-5, err_msg=name)
        assert _shape(got) == _shape(ref), name


# ------------------------------------------------------- the port alone

# the keys of the JAX package's compute_losses, which its train_loop logs
JAX_LOSS_KEYS = {"rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss", "mrcnn_bbox_loss", "mrcnn_mask_loss",
                 "total_loss"}


def test_train_resume_test_detect(workdir):  # noqa: F811 - the fixture
    logs = workdir / "logs"
    train = ["train", "--datalist", str(workdir / "list.dat"), "--nepochs", "1", "--nvalidation_steps", "1",
             "--logs", str(logs), "--no_augmentation"] + TINY + CPU
    assert tcli.main(train + ["--epoch_length", "2", "--grad_accum_steps", "2"]) == 0
    first = logs / "mask_rcnn_rg-dataset_0001.pt"
    assert sorted(os.listdir(logs)) == [first.name, "train_metrics.jsonl"]  # no loss_curve.png
    rows = [json.loads(line) for line in (logs / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 2]
    assert set(rows[0]) == {"step", "time"} | JAX_LOSS_KEYS
    assert set(rows[1]) == {"step", "time"} | {f"val_{k}" for k in JAX_LOSS_KEYS}
    assert all(np.isfinite(v) for r in rows for v in r.values())

    assert tcli.main(train + ["--epoch_length", "1", "--weights", str(first), "--nthreads", "2"]) == 0
    second = logs / "mask_rcnn_rg-dataset_0002.pt"
    assert second.is_file()
    assert [json.loads(line)["step"] for line in (logs / "train_metrics.jsonl").read_text().splitlines()] == [2, 2, 2, 2]

    assert tcli.main(["test", "--datalist", str(workdir / "list.dat"), "--weights", str(second), "--maxnimgs", "2",
                      "--scoreThr", "0.0", "--logs", str(logs)] + TINY + CPU) == 0
    assert (logs / "map_summary.json").is_file() and (logs / "groundtruths").is_dir()

    assert tcli.main(["detect", "--image", str(workdir / "img0.fits"), "--weights", str(second),
                      "--detect_outfile_json", str(workdir / "cat.json")] + TINY + CPU) == 0
    assert "objs" in json.loads((workdir / "cat.json").read_text())

    # export: the serving artifact from the same checkpoint (tests/test_cli_e2e.py's export leg)
    art = str(workdir / "detector.pt2")
    assert tcli.main(["export", "--weights", str(second), "--export_path", art] + TINY + CPU) == 0
    assert os.path.getsize(art) > 1000 and json.loads(open(art + ".json").read())["device"] == "cpu"
    srv = ServingDetector(art, device="cpu")
    assert srv.batch_size == 2
    out = srv.detect([np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)])
    assert len(out) == 1 and out[0]["masks"].shape[:2] == (64, 64)


def test_train_all_runs_the_port_cli(monkeypatch):
    """The legacy trainer hands its translated argv to the port's CLI."""
    from caesar_mrcnn_tpu_torch.cli import train_all

    seen = []
    monkeypatch.setattr(tcli, "main", lambda argv: seen.append(argv) or 0)
    assert train_all.main(["train", "--dataset", "list.dat", "--weights", "w.h5", "--weighttype", "coco"]) == 0
    assert train_all.main(["detect", "--dataset", "list.dat"]) == 1
    assert len(seen) == 1 and seen[0][0] == "train" and "--exclude_layers" in seen[0]


# ----------------------------------------------------------------- refusals


def _jax_config(argv):
    return jcli.build_config(jcli.parse_args(argv))


REFUSALS = {
    # name: (port argv, what the port raises or None for return code 1, the JAX CLI's behaviour)
    "export serving": (["export", "--export_path", "a.pt2", "--serving"], (NotImplementedError, "calibration images"),
                       lambda: jcli.validate_args(jcli.parse_args(["export", "--export_path", "a", "--serving"])) == 0
                       and _jax_config(["export", "--serving"]).quant_mode == "int8"),
    "export int8": (["export", "--export_path", "a.pt2", "--quant_mode", "int8"],
                    (NotImplementedError, "calibration images"),
                    lambda: _jax_config(["export", "--quant_mode", "int8"]).quant_mode == "int8"),
    "ngpu 2": (["detect", "--image", "x.fits", "--ngpu", "2"], (NotImplementedError, "A13"),
               lambda: _jax_config(["detect", "--ngpu", "2"]).num_devices == 2),
    "roi gather fp8": (["detect", "--image", "x.fits", "--roi_gather_dtype", "float8_e4m3fn"],
                       (NotImplementedError, "Not to port"),
                       lambda: _jax_config(["detect", "--roi_gather_dtype", "float8_e4m3fn"]).roi_gather_dtype
                       == "float8_e4m3fn"),
    "detect overlay untiled": (["detect", "--image", "x.fits", "--detect_outfile", "overlay.png"],
                               (NotImplementedError, "A16c"),
                               lambda: jcli.validate_args(jcli.parse_args(["detect", "--image", "x.fits",
                                                                           "--detect_outfile", "o.png"])) == 0
                               and not _jax_config(["detect", "--detect_outfile", "o.png"]).split_img_in_tiles),
    "train serving": (["train", "--datalist", "list.dat", "--serving"], None,
                      lambda: jcli.validate_args(jcli.parse_args(["train", "--datalist", "l", "--serving"])) == 0
                      and _jax_config(["train", "--serving"]).quant_mode == "int8"),
    "unknown class": (["detect", "--image", "x.fits", "--scoreThrPerClass", "sidelobes=0.9"] + CPU,
                      (SystemExit, "unknown class 'sidelobes'"),
                      lambda: _jax_config(["detect", "--scoreThrPerClass", "sidelobes=0.9"]).score_thr_per_class
                      == (("sidelobes", 0.9),)),
    "threshold not a number": (["detect", "--image", "x.fits", "--scoreThrPerClass", "sidelobe=high"] + CPU,
                               (SystemExit, "not a number"), None),
    "cuda without a card": (["detect", "--image", "x.fits"], (RuntimeError, "no CUDA device"), None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case, monkeypatch, tmp_path):
    """Each refusal comes before any work (no dataset, image or weights is
    read: none of them exists). Where the JAX CLI accepts the same argv,
    the check beside it holds that, so the difference stays visible; for
    a threshold that is not a number the JAX CLI raises a bare
    ``ValueError``, and it has no ``--device`` flag."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv, raises, jax_accepts = REFUSALS[case]
    if raises is None:
        assert tcli.main(argv) == 1
    else:
        with pytest.raises(raises[0], match=raises[1]):
            tcli.main(argv)
    if jax_accepts is not None:
        assert jax_accepts()
    elif case == "threshold not a number":
        with pytest.raises(ValueError):
            _jax_config(["detect", "--scoreThrPerClass", "sidelobe=high"])
    else:
        with pytest.raises(SystemExit):
            jcli.parse_args(argv + ["--device", "cuda"])
    assert os.listdir(tmp_path) == []
