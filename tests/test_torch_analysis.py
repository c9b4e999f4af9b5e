"""The port's host-layer pieces against the JAX package's, on the CPU, on
seeded numpy inputs: the contour tracer (native and plain) against
``cv2.findContours`` through the JAX package's ``find_contours_xy``;
``min_area_rect`` and ``moments`` against cv2; ``find_cliques`` against
networkx; and ``Analyzer.extract_det_masks`` -> ``compute_obj_pars`` ->
``make_json_results`` against the JAX package's ``Analyzer``.

Tolerances: contours, cliques, masks, classes, scores, boxes and pixels
exactly; the minimum-area rectangle within 1e-4 absolute (OpenCV computes
it in f32; the port repeats its operations in f32, but the order of a sum
may differ); moments and the centroids and photometry built on them
within 1e-9 relative (f64 sums in another order).
"""

import cv2
import networkx as nx
import numpy as np
import pytest
from scipy import ndimage

from caesar_mrcnn_tpu import config as jconfig
from caesar_mrcnn_tpu.analysis import masks as jmasks
from caesar_mrcnn_tpu.analysis.analyzer import Analyzer as JAnalyzer
from caesar_mrcnn_tpu_torch import config as tconfig
from caesar_mrcnn_tpu_torch import native as tnative
from caesar_mrcnn_tpu_torch.analysis import contours as C
from caesar_mrcnn_tpu_torch.analysis import masks as tmasks
from caesar_mrcnn_tpu_torch.analysis.analyzer import Analyzer as TAnalyzer
from caesar_mrcnn_tpu_torch.utils.graph import find_cliques

CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")


# ------------------------------------------------------------------ masks


def _rect(h, w, y1, x1, y2, x2):
    m = np.zeros((h, w), np.uint8)
    m[y1:y2, x1:x2] = 1
    return m


def _edge_masks():
    rng = np.random.RandomState(1)
    out = [np.ones((9, 7), np.uint8), _rect(12, 12, 0, 3, 5, 9), _rect(12, 12, 4, 0, 9, 4),
           _rect(12, 12, 7, 6, 12, 12), _rect(10, 10, 0, 0, 10, 1), _rect(10, 10, 9, 0, 10, 10)]
    for _ in range(20):  # blobs cut by the frame, as at every tile's border
        m = ndimage.uniform_filter((rng.rand(24, 24) < 0.5).astype(float), 5) > 0.45
        k = rng.randint(1, 4)
        m[:, :k] |= rng.rand(24, k) < 0.6
        out.append(np.rot90(m, rng.randint(4)).astype(np.uint8))
    return out


def _line_masks():
    out = [_rect(8, 12, 3, 1, 4, 11), _rect(12, 8, 1, 3, 11, 4), np.eye(9, dtype=np.uint8),
           np.fliplr(np.eye(9, dtype=np.uint8)).copy()]
    ell = np.zeros((10, 10), np.uint8)
    ell[1:9, 2] = 1
    ell[8, 2:9] = 1
    out.append(ell)
    spur = _rect(16, 16, 4, 4, 10, 10)
    spur[7, 10:15] = 1  # a 1-pixel spur off a block
    spur[10:14, 4] = 1
    spur[11, 2:4] = 1
    out.append(spur)
    cross = np.zeros((11, 11), np.uint8)
    cross[5, 1:10] = 1
    cross[1:10, 5] = 1
    out.append(cross)
    ring = _rect(10, 10, 2, 2, 8, 8) - _rect(10, 10, 3, 3, 7, 7)  # a closed 1-pixel ring
    out.append(ring.astype(np.uint8))
    zig = np.zeros((8, 14), np.uint8)
    for x in range(1, 13):
        zig[2 + (x % 3), x] = 1
    out.append(zig)
    return out


def _small_masks():
    out = []
    for (y1, x1), (y2, x2) in [((3, 3), (3, 3)), ((0, 0), (0, 0)), ((4, 5), (4, 5)), ((2, 2), (2, 3)),
                               ((2, 2), (3, 2)), ((2, 2), (3, 3)), ((3, 2), (2, 3)), ((0, 6), (0, 7))]:
        m = np.zeros((6, 8), np.uint8)
        m[y1, x1] = m[y2, x2] = 1
        out.append(m)
    return out


def _hole_masks():
    out = [(_rect(12, 12, 1, 1, 11, 11) - _rect(12, 12, 4, 4, 8, 8)).astype(np.uint8)]
    nested = out[0].copy()
    nested[5:7, 5:7] = 1  # an object inside the hole: RETR_EXTERNAL skips it
    out.append(nested)
    two = _rect(20, 20, 0, 0, 20, 20)
    two[3:8, 3:8] = 0
    two[10:16, 9:17] = 0
    two[12:14, 11:13] = 1
    out.append(two)
    yy, xx = np.mgrid[0:32, 0:32]
    r = np.hypot(yy - 15.5, xx - 15.5)
    out.append(((r < 14) & (r > 6)).astype(np.uint8))
    out.append((((r < 14) & (r > 9)) | (r < 4)).astype(np.uint8))
    return out


def _component_masks():
    out = []
    m = _rect(24, 24, 2, 2, 8, 8) | _rect(24, 24, 12, 14, 20, 22) | _rect(24, 24, 8, 8, 10, 10)
    out.append(m)  # the last block touches the first diagonally: one 8-component
    out.append(_rect(24, 24, 1, 1, 5, 5) | _rect(24, 24, 1, 8, 5, 12) | _rect(24, 24, 10, 1, 14, 20))
    rng = np.random.RandomState(2)
    for _ in range(10):
        m = np.zeros((32, 32), np.uint8)
        for _ in range(rng.randint(2, 6)):
            y, x = rng.randint(0, 28, 2)
            m[y:y + rng.randint(1, 6), x:x + rng.randint(1, 6)] = 1
        out.append(m)
    return out


def _seeded_masks():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(60):
        h, w = rng.randint(1, 48, 2)
        m = rng.rand(h, w) < rng.uniform(0.05, 0.9)
        if rng.rand() < 0.6:
            m = ndimage.uniform_filter(m.astype(float), rng.randint(1, 6)) > rng.uniform(0.2, 0.8)
        out.append(m.astype(np.uint8) * rng.choice([1, 255]))
    return out


MASK_CASES = {"edge": _edge_masks, "lines": _line_masks, "small": _small_masks, "holes": _hole_masks,
              "components": _component_masks, "seeded": _seeded_masks}


def _cv2_contours(mask):
    found, _ = cv2.findContours(np.ascontiguousarray(mask, np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    return [c[:, 0, :] for c in found]


def _assert_same_arrays(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_contour_tracer_equals_cv2(case):
    """The native tracer and its plain version give cv2's borders: the same
    list order, start points, directions and repeated pixels; and
    ``find_contours_xy`` equals the JAX package's (which drops borders of
    fewer than 3 points)."""
    masks = MASK_CASES[case]()
    for mask in masks:
        ref = _cv2_contours(mask)
        _assert_same_arrays(C.find_contours(mask), ref)
        _assert_same_arrays(C.find_contours_plain(mask), ref)
        _assert_same_arrays(tmasks.find_contours_xy(mask), jmasks.find_contours_xy(mask))
    if case == "small":  # single pixels and pairs give borders of 1 and 2 points, then dropped
        assert sorted({len(c) for m in masks for c in C.find_contours(m)}) == [1, 2]
        assert not any(tmasks.find_contours_xy(m) for m in masks)


def test_contour_tracer_grows_its_buffers(monkeypatch):
    """Buffers too small for the borders (here 1 point and 1 border: the
    first guess counts the mask's pixels, made 0): the tracer reports what
    it needed and the second call gives cv2's borders."""
    masks = [_line_masks()[6], _component_masks()[1], _hole_masks()[1]]  # a cross, 3 blocks, a nested ring
    refs = [_cv2_contours(m) for m in masks]
    monkeypatch.setattr(tnative.np, "count_nonzero", lambda a: 0)
    for mask, ref in zip(masks, refs):
        _assert_same_arrays(tnative.find_contours(mask), ref)


# ----------------------------------------------------- rectangle, moments


def _rect_cases():
    rng = np.random.RandomState(4)
    pts = []
    for mask in _edge_masks() + _line_masks() + _hole_masks() + _seeded_masks():
        pts += [c.astype(np.float32) for c in _cv2_contours(mask)]
    pts += [np.array(p, np.float32) for p in (
        [[0, 0], [4, 0], [4, 2], [0, 2]],            # axis-aligned: angle at -90
        [[0, 0], [0, 6], [3, 6], [3, 0]],
        [[0, 0], [2, 2], [0, 4], [-2, 2]],           # a square turned 45 degrees
        [[0, 0], [5, 0]], [[0, 0], [0, 5]],          # hulls of 2 points
        [[0, 0], [3, 3], [6, 6], [1, 1], [4, 4]],    # collinear
        [[2, 7], [2, 7], [2, 7]], [[1, 1]])]         # one point
    for _ in range(40):  # integer clouds with repeated points
        pts.append(rng.randint(0, 12, (rng.randint(3, 40), 2)).astype(np.float32))
    return pts


def test_min_area_rect_and_polygon_moments_equal_cv2():
    for p in _rect_cases():
        (cx, cy), (w, h), angle = C.min_area_rect(p)
        (rcx, rcy), (rw, rh), rangle = cv2.minAreaRect(p)
        np.testing.assert_allclose([cx, cy, w, h, angle], [rcx, rcy, rw, rh, rangle], rtol=0, atol=1e-4,
                                   err_msg=str(p.tolist()))
        np.testing.assert_array_equal(C.convex_hull(p), cv2.convexHull(p)[:, 0])
        got, ref = C.moments(p), cv2.moments(p)
        for k in ("m00", "m10", "m01"):
            assert got[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12), (k, p.tolist())


def test_image_moments_equal_cv2():
    """Binary u8 masks and f32 weighted images, as ``_add_source_params``
    calls them; an f32 image two columns wide is read as points by cv2,
    and by the port."""
    rng = np.random.RandomState(5)
    for h, w in [(7, 9), (1, 5), (5, 1), (2, 1), (5, 2), (31, 2), (40, 33), (1, 2)]:
        mask = (rng.rand(h, w) > 0.4).astype(np.uint8)
        weights = np.where(mask > 0, rng.uniform(0.1, 20.0, (h, w)), 0.0).astype(np.float32)
        for img, binary in ((mask, True), (weights, False)):
            got, ref = C.moments(img, binary), cv2.moments(img, binary)
            for k in ("m00", "m10", "m01"):
                assert got[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12), (k, h, w, binary)


def test_find_cliques_equals_networkx():
    rng = np.random.RandomState(6)
    for _ in range(300):
        n, p = rng.randint(0, 30), rng.uniform(0.0, 0.7)
        g = nx.Graph()
        g.add_nodes_from(range(n))
        adj = {i: [] for i in range(n)}
        for i in range(n):
            for j in range(i + 1, n):
                if rng.rand() < p:
                    g.add_edge(i, j)
                    adj[i].append(j)
                    adj[j].append(i)
        assert list(find_cliques(adj)) == list(nx.find_cliques(g))


# -------------------------------------------------------------- Analyzer


def _analyzers(**kw):
    base = dict(num_classes=4, class_names=CLASS_NAMES, score_thr=0.5, iou_thr=0.6)
    base.update(kw)
    return (TAnalyzer(detector=None, config=tconfig.detector_config(**base)),
            JAnalyzer(detector=None, config=jconfig.detector_config(**base)))


def _seeded_detections(seed, n, h=64, w=72, equal_scores=False):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = []
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(2, 12, 2)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        if rng.rand() < 0.3:  # a second island
            m |= ((yy - cy - 2 * ry - 3) / 2.0) ** 2 + ((xx - cx) / 3.0) ** 2 <= 1.0
        masks.append(m)
    masks = np.stack(masks, -1) if n else np.zeros((h, w, 0), bool)
    class_ids = rng.randint(1, 4, n)
    scores = np.full(n, 0.875) if equal_scores else rng.choice([0.45, 0.6, 0.75, 0.9, 0.95, rng.rand()], n)
    return masks, class_ids, scores.astype(np.float32)


def _cliques_with_ties():
    """Masks at one score: three that touch pairwise (two sources whose IoU
    is too small to merge, and a galaxy), and a sidelobe under a galaxy;
    each clique's best is its first member in networkx's order."""
    h = w = 48
    m = np.stack([_rect(h, w, 10, 10, 20, 20), _rect(h, w, 12, 14, 24, 26), _rect(h, w, 18, 8, 30, 18),
                  _rect(h, w, 30, 30, 40, 40), _rect(h, w, 31, 31, 41, 41)], -1)
    return m, np.array([2, 3, 2, 1, 3]), np.full(5, 0.95, np.float32)


ANALYZER_CASES = {
    # the cases of tests/test_analyzer.py
    "threshold and split": (dict(), lambda: (
        np.stack([_rect(64, 64, 2, 2, 8, 8) | _rect(64, 64, 30, 30, 40, 40), _rect(64, 64, 50, 50, 60, 60)], -1),
        np.array([2, 2]), np.array([0.9, 0.1]))),
    "merge same class": (dict(split_masks=False), lambda: (
        np.stack([_rect(64, 64, 10, 10, 20, 20), _rect(64, 64, 10, 12, 20, 22)], -1),
        np.array([2, 2]), np.array([0.8, 0.6]))),
    "best overlap across classes": (dict(split_masks=False), lambda: (
        np.stack([_rect(64, 64, 10, 10, 20, 20), _rect(64, 64, 12, 12, 22, 22)], -1),
        np.array([3, 2]), np.array([0.9, 0.6]))),
    "sidelobe keeps both": (dict(split_masks=False), lambda: (
        np.stack([_rect(64, 64, 10, 10, 20, 20), _rect(64, 64, 20, 10, 40, 40)], -1),
        np.array([1, 2]), np.array([0.9, 0.8]))),
    "per-class threshold": (dict(config=dict(score_thr_per_class=(("sidelobe", 0.9),))), lambda: (
        np.stack([_rect(64, 64, 2, 2, 10, 10), _rect(64, 64, 30, 30, 40, 40), _rect(64, 64, 50, 50, 60, 60)], -1),
        np.array([1, 1, 2]), np.array([0.8, 0.95, 0.6]))),
    "equal scores in a clique": (dict(), _cliques_with_ties),
    "no detections": (dict(), lambda: _seeded_detections(0, 0)),
    **{f"seeded {s}": (dict(), lambda s=s: _seeded_detections(s, 12 + 4 * s)) for s in range(4)},
    "seeded equal scores": (dict(), lambda: _seeded_detections(7, 16, equal_scores=True)),
    "seeded per-class thresholds, offset tile": (
        dict(config=dict(score_thr_per_class=(("sidelobe", 0.9), ("galaxy", 0.7))), xmin=512, ymin=1024),
        lambda: _seeded_detections(8, 20)),
}


def _assert_same(got, ref, path=""):
    """Nested catalogs equal: floats within 1e-9 relative, except the
    minimum-area rectangle's within 1e-4 absolute; all else exactly."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)) or (isinstance(ref, np.ndarray) and ref.dtype == object):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape and got.dtype == ref.dtype, path
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=path)
    elif isinstance(ref, float):
        tol = dict(rel=0, abs=1e-4) if "minAreaRect" in path else dict(rel=1e-9, abs=0)
        assert got == pytest.approx(ref, **tol), path
    else:
        assert type(got) is type(ref) and got == ref, path


@pytest.mark.parametrize("case", list(ANALYZER_CASES))
def test_analyzer_equals_jax(case):
    """extract_det_masks -> compute_obj_pars -> make_json_results: the same
    final masks, classes, scores and boxes, object parameters (contours,
    minAreaRect, centroid, photometry, SNR, beams) and catalog (pixels,
    vertexes, edge flags) as the JAX package's Analyzer."""
    opts, make = ANALYZER_CASES[case]
    masks, class_ids, scores = make()
    t_an, j_an = _analyzers(**opts.get("config", {}))
    rng = np.random.RandomState(9)
    raw = rng.normal(0.0, 0.05, masks.shape[:2]).astype(np.float32) + 5.0 * masks.sum(-1)
    meta = {"bkg": 0.01, "rms": 0.05, "bmaj": 1.5e-3, "bmin": 1.2e-3, "dx": -2.8e-4, "dy": 2.8e-4}
    for an in (t_an, j_an):
        an.split_masks = opts.get("split_masks", True)
        an.image = np.zeros(masks.shape[:2] + (3,), np.uint8)
        an.image_xmin, an.image_ymin = opts.get("xmin", 0), opts.get("ymin", 0)
        an.image_metadata = meta
        an.extract_det_masks(masks, class_ids, scores)
        an.compute_obj_pars(raw)
        an.make_json_results()
    assert len(t_an.masks_final) == len(j_an.masks_final)
    for a, b in zip(t_an.masks_final, j_an.masks_final):
        np.testing.assert_array_equal(a, b)
    assert (t_an.class_ids_final, t_an.class_names_final, t_an.scores_final) == (
        j_an.class_ids_final, j_an.class_names_final, j_an.scores_final)
    np.testing.assert_array_equal(np.array(t_an.bboxes), np.array(j_an.bboxes))
    _assert_same(t_an.obj_pars, j_an.obj_pars, "obj_pars")
    _assert_same(t_an.results, j_an.results, "results")
    if case.startswith("seeded ") and case != "seeded equal scores":
        assert t_an.masks_final and any(o["vertexes"] for o in t_an.results["objs"])


def test_analyzer_draw_waits_for_a16():
    an, _ = _analyzers()
    an.draw, an.outfile_img = True, "overlay.png"
    with pytest.raises(NotImplementedError, match="A16"):
        an.predict(np.zeros((8, 8, 3), np.uint8))
