"""The int8 detect cell's plain reference (``benchmark/reference/mrcnn_int8.py``)
beside the port's int8 serving graph on the CPU, at a small size (the
repository's custom backbone, 128^2 tiles, batch 2), and the cell's
harness around it:

* the port's folding, per-channel weights and calibrated scales against
  the reference's (scales within 1e-5 relative);
* the int8 pyramid bit for bit, and the heads, at the port's scales;
* the quantizer's ties, half to even;
* the cell through ``benchmark.run.run_cell`` in a fresh process (the
  tests' own process has JAX loaded, which the harness refuses): a sound
  run reads correct and loads nothing of JAX, each planted int8 fault and
  the 6-bit control read not correct;
* the int8 bounds against ``kernel_bench``'s, and the cell's three new
  readers on a hand-made record, ``None`` where their inputs are absent.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from caesar_mrcnn_tpu_torch import kernel_bench, weights as W
from caesar_mrcnn_tpu_torch.models import heads_int8 as Q
from caesar_mrcnn_tpu_torch.ops.quant import quantize_int8_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import int8_bounds as B  # noqa: E402
from benchmark import run as R  # noqa: E402
from benchmark.drivers.detect_tiles import Capture, build_detector, patched  # noqa: E402
from benchmark.faults_int8 import CONTROL, FAULTS  # noqa: E402
from benchmark.reference import judge_detect_int8 as J  # noqa: E402
from benchmark.reference import mrcnn_int8 as M  # noqa: E402
from benchmark.trace import TraceSummary  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

torch.set_num_threads(2)

CELL = "detect.r101-512-int8.tiles"
SMALL = dict(backbone="custom", top_down_pyramid_size=32, fpn_classif_fc_layers_size=64, image_min_dim=128,
             image_max_dim=128, images_per_device=2, pre_nms_limit=200, post_nms_rois_inference=40,
             detection_max_instances=6)
TRAFFIC = dict(mosaic_side=256, sources=12, warmup_passes=0, traced_batches=2, check_batches=1, check_from=0,
               check_before=1)


def small_config(**overrides):
    config = R.load_json(os.path.join(REPO, "benchmark", "configs", "mrcnn-r101-fpn256-512-int8.json"))
    return dict(config["config"], **SMALL, **overrides)


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def calibrated(request):
    """(config, weights, detector, molded tiles, the port's folded weights
    and scales, its calibration pass's proposals and detections), the
    detector calibrated by its first ``dispatch_tiles``."""
    cfg = small_config(compute_dtype=request.param)
    sd = make_weights(cfg, 11, "cpu")
    det = build_detector(cfg, sd, "cpu")
    tiles = np.random.RandomState(3).randint(0, 256, (2, 128, 128), np.uint8)
    keep = Capture(Q.forward_inference)
    keep.keep = True
    with patched(Q, "forward_inference", keep):
        det.collect(det.dispatch_tiles(tiles))
    folded = Q.fold_detect(W.state_dict_to_flax(det.model.state_dict()), det.config)
    scales = {site: float(q["s_in"]) for site, q in det.qtree.items()}
    return cfg, sd, det, J.mold(tiles, cfg, "cpu"), folded, scales, keep.kept


def test_folding_weights_and_scales_equal_the_ports(calibrated):
    cfg, sd, det, molded, folded, scales, kept = calibrated
    ours = M.fold(sd, cfg)
    assert set(ours) == set(folded) and len(det.qtree) == 60
    for base, (w, b) in ours.items():
        fw, fb = folded[base]
        assert torch.equal(w, torch.from_numpy(fw).permute(3, 2, 0, 1)), base
        assert torch.equal(b, torch.from_numpy(fb)), base
        q = det.qtree[base if base != "rpn/shared" else "rpn/shared@p2"]
        levels, s_w = M.quantize_weights(w)
        assert torch.equal(levels, torch.from_numpy(q["w"].astype(np.float32)).permute(3, 2, 0, 1)), base
        assert torch.equal(s_w * torch.tensor(q["s_in"]), torch.from_numpy(q["sw"])), base
    own = M.calibrate(sd, cfg, molded)
    assert set(own) == set(scales)
    rel, mismatch = J.scale_gaps(scales, own)
    assert rel < 1e-5 and mismatch == 0


def test_int8_pyramid_and_heads_equal_the_ports(calibrated):
    cfg, sd, det, molded, _, scales, kept = calibrated
    graph = M.Graph(sd, cfg, scales=scales)
    stages = det.int8_graph()
    with torch.no_grad():
        ours, theirs = graph.features(molded), stages.features(molded)
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b.float())  # integer sums, the same f32 epilogues: bit for bit
        shape = (128, 128)
        pooled = graph.roi_align(ours[:4], kept.rpn_rois, shape, cfg["pool_size"])
        probs, deltas = graph.classifier(pooled)
        _, p2, d2 = stages.classifier(pooled.to(stages.dtype).contiguous())
        masks = graph.mask_head(graph.roi_align(ours[:4], kept.detections[..., :4].contiguous(), shape, 14))
        m2 = stages.mask(graph.roi_align(ours[:4], kept.detections[..., :4].contiguous(), shape, 14)
                         .to(stages.dtype).contiguous())
    # the float layers: f32 in the reference, the compute dtype in the port
    tol = 1e-5 if cfg["compute_dtype"] == "float32" else 3e-2
    assert float((probs - p2).abs().max()) < tol
    assert float((deltas - d2).abs().max()) < tol * max(1.0, float(deltas.abs().max()))
    assert float((masks.permute(0, 1, 3, 4, 2) - m2).abs().max()) < tol


def test_the_quantizer_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 300.0, -300.0, 0.49999997])
    want = torch.tensor([0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 126.0, 127.0, 127.0, -127.0, 0.0])
    assert torch.equal(M.quantize(x, 1.0), want)
    assert torch.equal(M.quantize(x * 0.25, 0.25), want)  # powers of two: x / s exact, the ties kept
    assert torch.equal(quantize_int8_plain(x, 1.0).float(), want)


RUN = """
import json, sys
from benchmark import run as R
from benchmark.faults_int8 import planted
cfg, traffic = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for side in sys.argv[3].split(","):
    config = R.load_json("benchmark/configs/mrcnn-r101-fpn256-512-int8.json")
    config["config"] = cfg
    t = R.load_json("benchmark/traffic/tiles-int8.json")
    t.update(traffic)
    with planted(side) as factory:
        res = R.run_cell("{cell}", 2**31 + 7, 0.5, False, device="cpu", config=config, traffic=t,
                         make_detector=factory)
    print(json.dumps({{"side": side, "correct": res["correct"], "failed": res["failed"],
                      "compared": {{k: v["value"] for k, v in res["compared"].items()}},
                      "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}), flush=True)
"""


@pytest.fixture(scope="module")
def runs():
    """The cell at the small size, sound and with each fault and the
    control, in one fresh process."""
    sides = ["sound", *FAULTS, *CONTROL]
    out = subprocess.run([sys.executable, "-c", RUN.format(cell=CELL), json.dumps(small_config()),
                          json.dumps(TRAFFIC), ",".join(sides)], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["side"]: r for r in map(json.loads, out.stdout.strip().splitlines())}


def test_the_cell_reads_correct_and_loads_nothing_of_jax(runs):
    sound = runs["sound"]
    assert sound["correct"] and sound["failed"] == 0
    assert list(sound["compared"]) == list(J.COMPARED)
    assert abs(sound["compared"]["pyramid_err_ratio"] - 1.0) < 0.01 and sound["compared"]["act_scale_rel"] < 1e-5
    assert "caesar_mrcnn_tpu_torch" in sound["modules"]
    assert not set(R.FORBIDDEN) & set(sound["modules"])


@pytest.mark.parametrize("side", sorted(FAULTS) + sorted(CONTROL))
def test_a_planted_fault_or_the_control_is_not_correct(runs, side):
    res = runs[side]
    assert not res["correct"] and res["failed"] == 0  # found by the comparison, not by a missing answer
    limits = R.load_json(os.path.join(REPO, "benchmark", "limits", f"{CELL}.json"))
    assert any(v > limits[k] for k, v in res["compared"].items())


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys, benchmark.reference.mrcnn_int8, benchmark.reference.judge_detect_int8, "
            "benchmark.int8_bounds; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    modules = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in modules and not ({"caesar_mrcnn_tpu_torch"} | set(R.FORBIDDEN)) & modules


SITES = [kernel_bench.ConvSite("stem", 8, 512, 512, 16, 64, 7, 2, ((3, 3), (3, 3)), True),
         kernel_bench.ConvSite("res3a/conv1", 8, 128, 128, 256, 128, 1, 2, ((0, 0), (0, 0)), True, "then"),
         kernel_bench.ConvSite("cls/conv1", 4096, 7, 7, 256, 1024, 7, 1, ((0, 0), (0, 0)), True, "then"),
         kernel_bench.ConvSite("fpn/p2", 8, 128, 128, 256, 256, 3, 1, ((1, 1), (1, 1)))]


@pytest.mark.parametrize("site", SITES, ids=[s.name for s in SITES])
def test_int8_bounds_equal_kernel_bench(site):
    x = torch.empty(site.batch, site.h, site.w, site.cin, device="meta", dtype=torch.int8)
    w = torch.empty(site.cout, site.k, site.k, site.cin, device="meta", dtype=torch.int8)
    call = B.conv_call(x, w, None, None, site.stride, site.pads, site.relu, 0.1 if site.then else None)
    assert B.conv_int8_bound(call) == pytest.approx(kernel_bench.conv_int8_bound(site)[0], rel=1e-12)
    q = B.quantize_call(torch.empty(8, 512, 512, 3, device="meta"), 0.1, channels=16)
    assert B.quantize_bound(q) == pytest.approx(kernel_bench.quantize_bound(8 * 512 * 512 * 3, 4,
                                                                            8 * 512 * 512 * 16)[0])


_CONV = B.conv_call(torch.empty(8, 64, 64, 256, device="meta", dtype=torch.int8),
                    torch.empty(256, 3, 3, 256, device="meta", dtype=torch.int8), None, None, 1, ((1, 1), (1, 1)))
_QUANT = B.quantize_call(torch.empty(8, 64, 64, 256, device="meta", dtype=torch.bfloat16), 0.1, channels=256)
RECORD = {
    "trace": TraceSummary(window_s=0.5, busy_s=0.2, kernels=[
        ("void (anonymous namespace)::hop::conv_int8_wgmma_kernel<128>(CUtensorMap_st, Args)", 0.0, 0.004),
        ("(anonymous namespace)::conv_int8_kernel(ConvArgs)", 0.01, 0.001),
        ("void (anonymous namespace)::quantize_int8_kernel<__nv_bfloat16>(...)", 0.02, 0.0005),
        ("roi_align_kernel", 0.03, 0.001)]),
    "int8_conv_calls": [_CONV, _CONV], "int8_quantize_calls": [_QUANT],
    "int8_calibration": {"spans": {"detect.int8.calibrate": {"calls": 1, "total_ms": 1234.5, "self_ms": 10.0}},
                         "counters": {"detect.int8.sites": 123}, "batches": 1},
}
EXPECTED = {"int8_conv_roofline": 100.0 * 2 * B.conv_int8_bound(_CONV) * 1e-3 / 0.005,
            "int8_quantize_roofline": 100.0 * B.quantize_bound(_QUANT) * 1e-3 / 0.0005,
            "detect.int8_calibrate_s": 1.2345}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_int8_readers(name):
    read = R._metric_reader(name)
    assert read(RECORD) == pytest.approx(EXPECTED[name])
    assert 0 < read(RECORD) < 100 or name == "detect.int8_calibrate_s"
    # absent: the parent's program (no span) or an untraced run (no calls, no trace)
    assert read({"spans": {}, "trace": None, "int8_conv_calls": [], "int8_quantize_calls": []}) is None
    assert read(dict(RECORD, int8_calibration={"spans": {}, "counters": {}, "batches": 0}, int8_conv_calls=[],
                     int8_quantize_calls=[])) is None
