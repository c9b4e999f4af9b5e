"""The port's source classification (``analysis/classifier.py``,
``cli/sclassifier.py``) against the JAX package's, on the CPU:

* ``SClassifier`` with the fake detector of ``tests/test_classifier.py``
  on a seeded image: two blobs, a catalog source whose box crosses its
  neighbour's cutout (a cut flag), two catalog entries on one blob (each
  names the other in ``snames``), a source at the bottom border (a clipped
  cutout). The two catalogs must be equal byte for byte, and so must the
  sources' state. A source within half a cutout of the left or top edge
  fails the JAX package (ROADMAP C9); the port clamps that cutout to the
  image and classifies the source, and skips a source off the image;
* the same through both packages' real detectors on the same weights
  (``tests/test_torch_sfinder.py``'s detector: the custom backbone,
  128^2 cutouts, f32; ``PRNGKey(0)``'s variables settled by
  ``testing.settle_flax_weights``, so that the proposals spread over the
  cutout, and heads pinned by ``testing.pin_heads``, so that every
  detection has one score): the rows equal, scores within 1e-5, with at
  least one source classified;
* both CLIs' ``main`` on the same weights (the port with ``--device
  cpu``; the JAX CLI has no such flag), their configs narrowed to the same
  small detector: the catalogs as above;
* the refusal of a cutout size that is not a multiple of 64 before any
  file is read, beside the JAX package failing at that size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.analysis import classifier as jclassifier
from caesar_mrcnn_tpu.analysis.classifier import SClassifier as JSClassifier
from caesar_mrcnn_tpu.cli import sclassifier as jcli
from caesar_mrcnn_tpu.inference.detector import Detector as JaxDetector
from caesar_mrcnn_tpu.inference.detector import build_detector as jax_build_detector
from caesar_mrcnn_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from caesar_mrcnn_tpu.train import checkpoints as JCK
from caesar_mrcnn_tpu.utils import fits as jfits
from caesar_mrcnn_tpu_torch import weights as W
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch.analysis import classifier as tclassifier
from caesar_mrcnn_tpu_torch.analysis.classifier import SClassifier as TSClassifier
from caesar_mrcnn_tpu_torch.cli import sclassifier as tcli
from caesar_mrcnn_tpu_torch.inference import detector as tdetector
from caesar_mrcnn_tpu_torch.testing import pin_heads, settle_flax_weights
from caesar_mrcnn_tpu_torch.train import checkpoints as TCK
from caesar_mrcnn_tpu_torch.utils import fits as F
from test_classifier import FakeDetector
from test_torch_sfinder import CLASS_NAMES, DETECT_KW

torch.set_num_threads(2)

# name, x0, y0, xmin, xmax, ymin, ymax
ROWS = [
    ("S1", 110, 110, 100, 120, 100, 120),
    ("S1b", 111, 109, 100, 120, 100, 120),  # the same blob again: S1 and S1b name each other
    ("S3", 172, 108, 160, 185, 100, 116),  # inside S1's cutout, its box past the cutout's edge
    ("S2", 240, 207, 230, 250, 200, 215),
    ("S4", 150, 290, 140, 162, 282, 299),  # at the bottom border: a clipped cutout
]
# within half a cutout of the left edge: the crop's start is negative and wraps
LEFT = ("S5", 30, 150, 22, 38, 142, 158)
# within half a cutout of the top edge
TOP = ("S6", 250, 20, 242, 258, 12, 28)
# off the image, left of it: every cutout window misses the image
OFF = ("S7", -100, 150, -108, -92, 142, 158)


def write_inputs(tmp_path, rows=ROWS):
    """A seeded 300^2 FITS image with a +5 block under each catalog row's
    box, and the 17-column ascii catalog of ``read_scatalog``."""
    rng = np.random.RandomState(1)
    data = rng.normal(0, 0.01, (300, 300)).astype(np.float32)
    for _, _, _, xmin, xmax, ymin, ymax in rows:
        data[ymin:ymax, xmin:xmax] = 5.0 + rng.normal(0, 0.01, (ymax - ymin, xmax - xmin))
    img_path = str(tmp_path / "img.fits")
    F.write_fits(data, img_path)
    cat_path = str(tmp_path / "catalog.dat")
    with open(cat_path, "w") as f:
        f.write("# header\n")
        for name, x0, y0, xmin, xmax, ymin, ymax in rows:
            cols = [name] + ["0"] * 4 + [str(x0), str(y0)] + ["0"] * 6 + [
                str(xmin), str(xmax), str(ymin), str(ymax), "0",
            ]
            f.write(" ".join(cols) + "\n")
    return img_path, cat_path


def classify_both(tmp_path, classifiers, paths):
    """Run each (name, SClassifier) on the inputs and write its catalog;
    {name: (catalog bytes, sources as dicts)}."""
    out = {}
    for name, sc in classifiers:
        assert sc.run(*paths) == 0
        path = tmp_path / f"{name}.dat"
        sc.write_catalog(str(path))
        out[name] = (path.read_bytes(), [dataclasses.asdict(s) for s in sc.sources])
    return out


def rows(catalog: bytes):
    """(name, x0, y0, class_id, class_name) and the score of each row."""
    lines = catalog.decode().splitlines()
    assert lines[0] == "# name x0 y0 class_id class_name score"
    return [tuple(line.split()[:5]) for line in lines[1:]], [float(line.split()[5]) for line in lines[1:]]


def assert_same_rows(out, min_classified=1):
    (got, got_scores), (ref, ref_scores) = rows(out["torch"][0]), rows(out["jax"][0])
    assert got == ref
    np.testing.assert_allclose(got_scores, ref_scores, rtol=0, atol=1e-5)
    assert sum(r[3] != "-1" for r in ref) >= min_classified, ref


def test_sclassifier_fake_detector_equals_jax(tmp_path):
    paths = write_inputs(tmp_path)
    cfgs = [mod.detector_config(num_classes=4, class_names=CLASS_NAMES, score_thr=0.5, iou_thr=0.6)
            for mod in (tconfig, jconfig)]
    out = classify_both(tmp_path, [("torch", TSClassifier(FakeDetector(), cfgs[0])),
                                   ("jax", JSClassifier(FakeDetector(), cfgs[1]))], paths)
    assert out["torch"] == out["jax"]
    sources = {s["name"]: s for s in out["torch"][1]}
    assert sources["S1"]["class_info"][0]["snames"] == ["S1b"]
    assert sources["S1b"]["class_info"][0]["snames"] == ["S1"]
    # S3 crosses S1's cutout: left unvisited there, classified in a cutout of its own
    assert len(sources["S3"]["class_info"]) == 2
    assert sources["S4"]["class_info"]


def test_source_at_the_left_edge_fails_both(tmp_path):
    """A source within half a cutout of the left edge: the crop's window
    starts below 0 and the slice wraps to an empty cutout, on which both
    packages' ``utils/fits.py::crop_img`` raise; the JAX ``SClassifier``
    crops through it and stops there (ROADMAP C9). The port's classifier
    clamps the window first (``test_port_clamps_cutouts_at_the_left_and_top_edges``)."""
    paths = write_inputs(tmp_path, ROWS + [LEFT])
    data = F.read_fits(paths[0], stretch=False, normalize=False, convert_to_rgb=False)[0]
    _, x0, y0 = LEFT[:3]
    for crop_img in (F.crop_img, jfits.crop_img):
        with pytest.raises(ValueError, match="zero-size array"):
            crop_img(data, x0, y0, 128, 128, stretch=True, normalize=True, convert_to_rgb=True)
    sc = JSClassifier(FakeDetector(), jconfig.detector_config(num_classes=4, class_names=CLASS_NAMES))
    with pytest.raises(ValueError, match="zero-size array"):
        sc.run(*paths)


def test_port_clamps_cutouts_at_the_left_and_top_edges(tmp_path):
    """ROADMAP C9's fix in the port: with sources within half a cutout of
    the left and of the top edge, and one off the image, the port's
    classifier runs; the edge sources are classified on cutouts clamped to
    the image (their blocks found at their catalog boxes: IoU 1 with the
    fake detector's), the one off the image is skipped as an empty cutout,
    and every other row is the JAX package's on the catalog without them."""
    cfg = tconfig.detector_config(num_classes=4, class_names=CLASS_NAMES, score_thr=0.5, iou_thr=0.6)
    paths = write_inputs(tmp_path, ROWS + [LEFT, TOP])
    name, x0, y0, xmin, xmax, ymin, ymax = OFF
    with open(paths[1], "a") as f:
        f.write(" ".join([name] + ["0"] * 4 + [str(x0), str(y0)] + ["0"] * 6
                         + [str(xmin), str(xmax), str(ymin), str(ymax), "0"]) + "\n")
    sc = TSClassifier(FakeDetector(), cfg)
    sc.scutout_size = 128
    left, top, off = len(ROWS), len(ROWS) + 1, len(ROWS) + 2
    assert sc.read_img(paths[0]) == 0 and sc.read_scatalog(paths[1]) == 0
    assert sc._make_cutout(sc.sources[left]).shape == (128, 94, 3)  # window x from -34, clamped at 0
    assert sc._make_cutout(sc.sources[top]).shape == (84, 114, 3)  # y from -44; x to 314, past 300
    assert sc._make_cutout(sc.sources[off]).size == 0
    assert sc._sources_in_cutout(left) == ([left], [[142 - 86, 22, 158 - 86, 38]], [False])
    assert sc._sources_in_cutout(top) == ([top], [[12, 242 - 186, 28, 258 - 186]], [False])

    sc = TSClassifier(FakeDetector(), cfg)
    assert sc.run(*paths) == 0
    sc.write_catalog(str(tmp_path / "torch.dat"))
    got = (tmp_path / "torch.dat").read_bytes().decode().splitlines()
    assert got[-3:] == ["S5 30.0 150.0 2 source 0.9000", "S6 250.0 20.0 2 source 0.9000",
                        "S7 -100.0 150.0 -1 unclassified 0.0"]
    (tmp_path / "ref").mkdir()
    ref_paths = write_inputs(tmp_path / "ref", ROWS)
    ref = JSClassifier(FakeDetector(), jconfig.detector_config(num_classes=4, class_names=CLASS_NAMES,
                                                               score_thr=0.5, iou_thr=0.6))
    assert ref.run(*ref_paths) == 0
    ref.write_catalog(str(tmp_path / "jax.dat"))
    assert got[:-3] == (tmp_path / "jax.dat").read_bytes().decode().splitlines()


def test_sclassifier_helpers_equal_jax(tmp_path):
    """The IoU helper on seeded boxes (touching and disjoint ones too), and
    the catalog read, each cutout's sources, local boxes and cut flags."""
    rng = np.random.RandomState(2)
    for _ in range(300):
        b1 = rng.randint(0, 40, 4).astype(float)
        b2 = rng.randint(0, 40, 4).astype(float)
        b1[2:] += b1[:2]
        b2[2:] += b2[:2]
        assert tclassifier._bbox_iou(b1, b2) == jclassifier._bbox_iou(b1, b2)
    _, cat = write_inputs(tmp_path)
    cfgs = (tconfig.detector_config(), jconfig.detector_config())
    scs = (TSClassifier(None, cfgs[0]), JSClassifier(None, cfgs[1]))
    assert [sc.read_scatalog(cat) for sc in scs] == [0, 0]
    assert [dataclasses.asdict(s) for s in scs[0].sources] == [dataclasses.asdict(s) for s in scs[1].sources]
    for size in (64, 128, 132):
        for sc in scs:
            sc.scutout_size = size
        for i in range(len(ROWS)):
            assert scs[0]._sources_in_cutout(i) == scs[1]._sources_in_cutout(i)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """(JAX Detector, port Detector on the CPU, the port's ``.pt``, the JAX
    package's orbax checkpoint) with the same weights: ``PRNGKey(0)``'s
    variables, settled and then pinned."""
    root = tmp_path_factory.mktemp("weights")
    tcfg = tconfig.inference_config(tconfig.detector_config(**DETECT_KW))
    jcfg = jconfig.inference_config(jconfig.detector_config(**DETECT_KW))
    jmodel = JaxMaskRCNN(jcfg)
    dummy = jnp.zeros((1,) + jcfg.image_shape, jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(key, dummy, train=False))(jax.random.PRNGKey(0))
    tdet = tdetector.build_detector(tcfg, device="cpu",
                                    weights=settle_flax_weights(jax.tree_util.tree_map(np.array, variables)))
    pin_heads(tdet.model)
    tree = W.state_dict_to_flax(tdet.model.state_dict())
    pt = TCK.save_checkpoint(str(root / "torch"), tcfg.name, 1, tdet.model)
    orbax = JCK.save_checkpoint(str(root / "jax"), jcfg.name, 1, tree)
    return JaxDetector(jcfg, jmodel, tree), tdet, pt, orbax


def test_sclassifier_through_the_detectors_equals_jax(detectors, tmp_path):
    """Both packages' Detectors on the same weights, 128^2 cutouts."""
    jdet, tdet = detectors[:2]
    paths = write_inputs(tmp_path)
    scs = [("torch", TSClassifier(tdet, tdet.config)), ("jax", JSClassifier(jdet, jdet.config))]
    for _, sc in scs:
        # the random proposals meet the catalog's boxes at IoU 0.01-0.1: a low
        # threshold lets them match, so that classes and scores are compared
        sc.scutout_size, sc.iou_thr = 128, 0.01
    out = classify_both(tmp_path, scs, paths)
    assert_same_rows(out)


@pytest.fixture()
def small_cli(monkeypatch):
    """Both CLIs build ``test_torch_sfinder.py``'s small f32 detector at the
    cutout size (the CLIs have no flags for the backbone, the proposal
    budget or the dtype)."""
    small = {k: v for k, v in DETECT_KW.items() if k not in ("image_min_dim", "image_max_dim", "num_classes",
                                                             "class_names")}
    for cli in (tcli, jcli):
        make = cli.detector_config
        monkeypatch.setattr(cli, "detector_config", lambda _make=make, **kw: _make(**{**kw, **small}))


def test_cli_equals_jax_cli(detectors, small_cli, tmp_path):
    """``main`` of both CLIs on the same weights (the port's ``.pt``, the
    JAX package's orbax checkpoint), 128^2 cutouts."""
    img, cat = write_inputs(tmp_path)
    argv = ["--image", img, "--scatalog", cat, "--scutout_size", "128", "--iouThr", "0.01",
            "--classdict", '{"sidelobe":1,"source":2,"galaxy":3}']
    out = {}
    for name, cli, extra, w in (("jax", jcli, [], detectors[3]), ("torch", tcli, ["--device", "cpu"], detectors[2])):
        path = tmp_path / f"{name}.dat"
        assert cli.main(argv + extra + ["--weights", w, "--outfile", str(path)]) == 0
        out[name] = (path.read_bytes(), None)
    assert_same_rows(out)


def test_flags_equal_jax():
    argv = ["--image", "a.fits", "--scatalog", "c.dat"]
    got, ref = vars(tcli.parse_args(argv)), vars(jcli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref and ref["scutout_size"] == 132
    assert tcli.DEFAULT_CLASSDICT == jcli.DEFAULT_CLASSDICT


@pytest.mark.parametrize("size", [132, 100, 0])
def test_cutout_size_refused_before_any_read(size, monkeypatch, tmp_path):
    """A size that is not a positive multiple of 64 is refused before any
    image, catalog or weight is read and before a model is built (none of
    the files exists)."""
    monkeypatch.chdir(tmp_path)
    touched = []
    monkeypatch.setattr(F, "read_fits", lambda *a, **k: touched.append("read_fits"))
    monkeypatch.setattr(tdetector, "build_detector", lambda *a, **k: touched.append("build_detector"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="multiple of 64"):
        tcli.main(["--image", "a.fits", "--scatalog", "c.dat", "--weights", "w.pt", "--scutout_size", str(size)])
    assert touched == [] and list(tmp_path.iterdir()) == []


def test_cuda_without_a_card_refused(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--image", "a.fits", "--scatalog", "c.dat", "--scutout_size", "128"])


def test_both_detectors_fail_at_132():
    """What the refusal guards against: at a 132^2 cutout the FPN's
    top-down add meets a 10 x 10 map and a 9 x 9 one, in the JAX package
    (its CLI's default) and in the port's Detector alike."""
    kw = dict(DETECT_KW, image_min_dim=132, image_max_dim=132)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_build_detector(jconfig.inference_config(jconfig.detector_config(**kw)))
    det = tdetector.build_detector(tconfig.inference_config(tconfig.detector_config(**kw)), device="cpu")
    with pytest.raises(RuntimeError, match="must match"):
        det.detect([np.zeros((132, 132, 3), np.float32)])
