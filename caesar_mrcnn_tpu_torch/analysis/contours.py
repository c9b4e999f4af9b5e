"""Contours, minimum-area rectangles and moments of binary masks: the three
OpenCV calls of the JAX package's host layer, which the port does without
(the card's machine has no cv2).

* :func:`find_contours` equals ``cv2.findContours(mask, cv2.RETR_EXTERNAL,
  cv2.CHAIN_APPROX_NONE)`` (the JAX package's ``analysis/masks.py:107-110``):
  the same borders, in the same order, each from the same start point in
  the same direction. The native library traces them
  (``native/fastops.cpp::find_contours_external``);
  :func:`find_contours_plain` is the same algorithm in Python, which runs
  where the library did not load.
* :func:`min_area_rect` equals ``cv2.minAreaRect`` of OpenCV 5.0
  (``analysis/analyzer.py:223``): Sklansky's convex hull, then rotating
  calipers in f32, the angle in [-90, 0).
* :func:`moments` gives ``m00``, ``m10`` and ``m01`` as ``cv2.moments``
  does, of a polygon (``analyzer.py:230``) or of an image, binary or f32
  weighted (``sfinder.py:574,580``).

OpenCV is Apache-2.0; these follow its algorithms (``contours.cpp``,
``convhull.cpp``, ``rotcalipers.cpp``, ``moments.cpp``), and the tests hold
each to cv2 on seeded masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .. import native

# OpenCV's chain-code directions: 0 right, 1 up-right, 2 up, 3 up-left,
# 4 left, 5 down-left, 6 down, 7 down-right (y grows downward).
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_EDGE = 2 | -128  # a followed border pixel whose right neighbour is 0


def find_contours(mask: np.ndarray) -> List[np.ndarray]:
    """Outer borders of the nonzero pixels of a 2-D mask, each an int32
    ``[N, (x, y)]`` array, as ``cv2.findContours(mask, RETR_EXTERNAL,
    CHAIN_APPROX_NONE)`` lists them (single pixels and 2-point borders
    included)."""
    return native.find_contours(mask)


def find_contours_plain(mask: np.ndarray) -> List[np.ndarray]:
    """:func:`find_contours` in Python (the native tracer's plain version).

    Suzuki & Abe's border following as OpenCV runs it for RETR_EXTERNAL:
    the mask, nonzero as 1, sits in a frame of zeros one pixel wide; a
    raster scan starts a border at every 0 -> 1 step whose last border
    pixel met on the row is not an inner pixel of a border already
    followed (that is, the border is not inside a hole); following marks
    each border pixel 2, or ``_RIGHT_EDGE`` where its right neighbour was
    examined as background. OpenCV lists the borders last found first.
    """
    m = np.asarray(mask)
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m != 0
    flat = img.reshape(-1)
    stride = w + 2
    delta = [_DY[s] * stride + _DX[s] for s in range(8)] * 2
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd = 0  # column of the last border pixel met on this row
        prev = 0
        x = 1
        while x <= w:
            step = np.flatnonzero(row[x : w + 1] != prev)
            if step.size == 0:
                break
            x += int(step[0])
            if prev == 0 and row[x] == 1 and row[lnbd] <= 0:
                found.append(_follow_border(flat, delta, y * stride + x, x, y))
                lnbd = x
            prev = int(row[x])
            if prev & -2:
                lnbd = x
            x += 1
    return found[::-1]


def _follow_border(flat: np.ndarray, delta, i0: int, x: int, y: int) -> np.ndarray:
    """One outer border from frame pixel ``i0`` = (x, y), marked as it is
    followed (OpenCV's ``icvFetchContour``); points in mask coordinates."""
    s = 4
    while True:  # the last border pixel: clockwise from the left neighbour
        s = (s - 1) & 7
        i1 = i0 + delta[s]
        if flat[i1] != 0 or s == 4:
            break
    if s == 4:  # a single pixel
        flat[i0] = _RIGHT_EDGE
        return np.array([[x - 1, y - 1]], np.int32)
    pts = []
    i3 = i0
    while True:
        s_end = s
        while True:  # counterclockwise from the one after the previous pixel
            s += 1
            i4 = i3 + delta[s]
            if flat[i4] != 0 or s >= 15:
                break
        s &= 7
        if 1 <= s <= s_end:
            flat[i3] = _RIGHT_EDGE
        elif flat[i3] == 1:
            flat[i3] = 2
        pts.append((x - 1, y - 1))
        x += _DX[s]
        y += _DY[s]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.array(pts, np.int32)


# ------------------------------------------------------------------ rectangle

_f32 = np.float32


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(p, start: int, end: int, stack: List[int], nsign: int, sign2: int) -> int:
    """One quarter of Sklansky's scan over the sorted points ``p`` (OpenCV's
    ``Sklansky_``); fills ``stack`` with positions, returns their count."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or p[start] == p[end]:
        stack[0] = start
        return 1
    stack[0:3] = [pprev, pcur, pnext]
    size = 3
    end += incr
    while pnext != end:
        cury, nexty = p[pcur][1], p[pnext][1]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = p[pcur][0] - p[pprev][0]
            bx = p[pnext][0] - p[pcur][0]
            ay = cury - p[pprev][1]
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return size - 1


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Counterclockwise convex hull of f32 points ``[N, 2]`` as
    ``cv2.convexHull(points)`` returns it: the same vertices from the same
    start (OpenCV rotates the hull so that the points' indices ascend or
    descend where they can). OpenCV sorts with ``std::sort``, this with a
    stable sort: they can differ only in which of two equal points stands
    for a vertex."""
    pts = [(_f32(x), _f32(y)) for x, y in np.asarray(points, np.float32).reshape(-1, 2)]
    total = len(pts)
    if total == 0:
        return np.zeros((0, 2), np.float32)
    order = sorted(range(total), key=lambda i: (float(pts[i][0]), float(pts[i][1])))
    p = [pts[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if p[miny][1] > p[i][1]:
            miny = i
        if p[maxy][1] < p[i][1]:
            maxy = i
    hull: List[int] = []
    if p[0] == p[-1]:
        hull.append(order[0])
    else:
        tl, tr = [0] * (total + 2), [0] * (total + 2)
        tl_count = _sklansky(p, 0, maxy, tl, -1, 1)
        tr_count = _sklansky(p, total - 1, maxy, tr, -1, -1)
        tl, tr, tl_count, tr_count = tr, tl, tr_count, tl_count  # counterclockwise
        hull += [order[tl[i]] for i in range(tl_count - 1)]
        hull += [order[tr[i]] for i in range(tr_count - 1, 0, -1)]
        stop = tr[1] if tr_count > 2 else (tl[tl_count - 2] if tl_count > 2 else -1)
        bl, br = [0] * (total + 2), [0] * (total + 2)
        bl_count = _sklansky(p, 0, miny, bl, 1, -1)
        br_count = _sklansky(p, total - 1, miny, br, 1, 1)
        if stop >= 0:
            check = bl[1] if bl_count > 2 else (br[2 - bl_count] if bl_count + br_count > 2 else -1)
            if check == stop or (check >= 0 and p[check] == p[stop]):
                # all points on one line: the lower part mirrors the upper
                bl_count, br_count = min(bl_count, 2), min(br_count, 2)
        hull += [order[bl[i]] for i in range(bl_count - 1)]
        hull += [order[br[i]] for i in range(br_count - 1, 0, -1)]
        hull = _ascending_rotation(hull)
    return np.array([pts[i] for i in hull], np.float32).reshape(-1, 2)


def _ascending_rotation(hull: List[int]) -> List[int]:
    """OpenCV's cyclic shift of the hull that makes its point indices one
    ascending or descending run, where one exists."""
    n = len(hull)
    if n < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, n):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    dist = abs(max_i - min_i)
    if (dist == 1 or dist == n - 1) and (lt <= 1 or lt >= n - 2):
        ascending = (max_i + 1) % n == min_i
        start = min_i if ascending else max_i
        if start > 0:
            out = [hull[(start + i) % n] for i in range(n)]
            if all(ascending == (out[i] < out[i + 1]) for i in range(n - 1)):
                return out
    return hull


def _rotating_calipers(p: List[Tuple[np.float32, np.float32]]):
    """OpenCV's ``rotatingCalipers`` in its minimum-area mode, in f32 as it
    computes: (corner x, corner y, width vector, height vector)."""
    n = len(p)
    vect, inv = [], []
    left = bottom = right = top = 0
    left_x = right_x = p[0][0]
    top_y = bottom_y = p[0][1]
    for i in range(n):
        pt0, pt = p[i], p[(i + 1) % n]
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        dx, dy = float(pt[0] - pt0[0]), float(pt[1] - pt0[1])
        vect.append((_f32(dx), _f32(dy)))
        inv.append(_f32(1.0 / math.sqrt(dx * dx + dy * dy)))
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    orientation = 0.0
    for bx, by in vect:
        convexity = ax * float(by) - ay * float(bx)
        if convexity != 0:
            orientation = 1.0 if convexity > 0 else -1.0
            break
        ax, ay = float(bx), float(by)
    base_a, base_b = _f32(orientation), _f32(0.0)
    seq = [bottom, right, top, left]
    minarea = _f32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        dp = (base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
              -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
              -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
              base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1])
        main, maxcos = 0, dp[0] * inv[seq[0]]
        for i in range(1, 4):
            cosalpha = dp[i] * inv[seq[i]]
            if cosalpha > maxcos:
                main, maxcos = i, cosalpha
        lead = seq[main]
        lx, ly = vect[lead][0] * inv[lead], vect[lead][1] * inv[lead]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (seq[main] + 1) % n
        dx, dy = p[seq[1]][0] - p[seq[3]][0], p[seq[1]][1] - p[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx, dy = p[seq[2]][0] - p[seq[0]][0], p[seq[2]][1] - p[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    leftmost, a1, width, b1, height, lowest = best
    a2, b2 = -b1, a1
    c1 = a1 * p[leftmost][0] + p[leftmost][1] * b1
    c2 = a2 * p[lowest][0] + p[lowest][1] * b2
    idet = _f32(1.0) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return px, py, (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """``((cx, cy), (w, h), angle)`` of the least-area rectangle around f32
    points, as ``cv2.minAreaRect`` (OpenCV 5.0) returns it: the angle in
    degrees in [-90, 0), ``w`` along the angle's direction. Collinear
    points give a rectangle of height 0; one point, of size 0."""
    hull = convex_hull(points)
    n = len(hull)
    half = _f32(0.5)
    if n > 2:
        px, py, (wx, wy), (hx, hy) = _rotating_calipers([(x, y) for x, y in hull])
        cx, cy = px + (wx + hx) * half, py + (wy + hy) * half
        w = math.sqrt(float(wx) ** 2 + float(wy) ** 2)
        h = math.sqrt(float(hx) ** 2 + float(hy) ** 2)
        angle = math.atan2(float(wy), float(wx))
    elif n == 2:
        cx, cy = (hull[0][0] + hull[1][0]) * half, (hull[0][1] + hull[1][1]) * half
        dx, dy = float(hull[1][0] - hull[0][0]), float(hull[1][1] - hull[0][1])
        w, h = math.sqrt(dx * dx + dy * dy), 0.0
        angle = math.atan2(dy, dx)
    else:
        cx, cy = (hull[0][0], hull[0][1]) if n else (0.0, 0.0)
        w = h = angle = 0.0
    w, h = float(_f32(w)), float(_f32(h))
    angle = float(_f32(float(_f32(angle) * _f32(180.0)) / math.pi))
    # OpenCV 5.0 reports the same rectangle with its angle in [-90, 0):
    # each quarter turn swaps width and height
    while angle >= 0.0:
        angle, w, h = angle - 90.0, h, w
    while angle < -90.0:
        angle, w, h = angle + 90.0, h, w
    return (float(cx), float(cy)), (w, h), angle


# -------------------------------------------------------------------- moments


def moments(a: np.ndarray, binary: bool = False) -> Dict[str, float]:
    """``m00``, ``m10`` and ``m01`` as ``cv2.moments(a, binary)`` gives them.

    As OpenCV reads its input: an f32 or int32 array of two columns is a
    polygon of points (x, y) (its ``checkVector(2)``), whose moments come
    from Green's theorem in f64 (zero when the area is within f32 epsilon
    of 0); any other 2-D array is an image, whose pixels (nonzero as 1
    with ``binary``) weigh their coordinates. So an f32 image two columns
    wide is read as a polygon, as cv2 reads it.
    """
    a = np.asarray(a)
    if a.ndim == 2 and a.shape[1] == 2 and a.dtype in (np.float32, np.int32):
        return _polygon_moments(a.astype(np.float64))
    img = (a != 0) if binary else a
    img = img.astype(np.float64)
    ys, xs = np.arange(img.shape[0], dtype=np.float64), np.arange(img.shape[1], dtype=np.float64)
    return {"m00": float(img.sum()), "m10": float((img.sum(axis=0) * xs).sum()),
            "m01": float((img.sum(axis=1) * ys).sum())}


def _polygon_moments(p: np.ndarray) -> Dict[str, float]:
    if len(p) == 0:
        return {"m00": 0.0, "m10": 0.0, "m01": 0.0}
    x, y = p[:, 0], p[:, 1]
    x1, y1 = np.roll(x, 1), np.roll(y, 1)  # the previous point, cyclically
    dxy = x1 * y - x * y1
    a00 = float(dxy.sum())
    if abs(a00) <= np.finfo(np.float32).eps:
        return {"m00": 0.0, "m10": 0.0, "m01": 0.0}
    sign = 1.0 if a00 > 0 else -1.0
    return {"m00": a00 * (sign * 0.5), "m10": float((dxy * (x1 + x)).sum()) * (sign / 6.0),
            "m01": float((dxy * (y1 + y)).sum()) * (sign / 6.0)}
