"""Overlapping tile-grid generation for mosaic decomposition.

The port's copy of ``caesar_mrcnn_tpu/utils/tiles.py``, unchanged in behaviour
(the port imports nothing of the JAX package).

Behavioral parity with the reference's grid generator
(reference: mrcnn/utils.py:1254-1329): fractional steps < 1 produce halo
overlap; the last tile in each axis is clamped to the image edge.
"""

from __future__ import annotations

from typing import List, Tuple


def generate_tiles(
    img_xmin: int,
    img_xmax: int,
    img_ymin: int,
    img_ymax: int,
    tile_x: int,
    tile_y: int,
    step_x: float = 1.0,
    step_y: float = 1.0,
) -> List[Tuple[int, int, int, int]]:
    """Return [(xmin, xmax, ymin, ymax), ...] tile pixel windows.

    ``xmax``/``ymax`` are exclusive. step_{x,y} are fractions of the tile
    size (1.0 = no overlap).
    """
    if img_xmax <= img_xmin or img_ymax <= img_ymin:
        raise ValueError("image extent must be positive")
    if tile_x <= 0 or tile_y <= 0:
        raise ValueError("tile size must be positive")
    if not (0 < step_x <= 1) or not (0 < step_y <= 1):
        raise ValueError("steps must be in (0, 1]")

    nx = img_xmax - img_xmin
    ny = img_ymax - img_ymin
    tile_x = min(tile_x, nx)
    tile_y = min(tile_y, ny)
    dx = max(1, int(round(tile_x * step_x)))
    dy = max(1, int(round(tile_y * step_y)))

    xs: List[Tuple[int, int]] = []
    x = img_xmin
    while True:
        x2 = x + tile_x
        if x2 >= img_xmax:
            xs.append((img_xmax - tile_x, img_xmax))
            break
        xs.append((x, x2))
        x += dx
    ys: List[Tuple[int, int]] = []
    y = img_ymin
    while True:
        y2 = y + tile_y
        if y2 >= img_ymax:
            ys.append((img_ymax - tile_y, img_ymax))
            break
        ys.append((y, y2))
        y += dy

    # De-duplicate (possible when the clamped final tile equals the previous)
    xs = list(dict.fromkeys(xs))
    ys = list(dict.fromkeys(ys))
    return [(x1, x2, y1, y2) for (y1, y2) in ys for (x1, x2) in xs]


def tiles_overlap(
    t1: Tuple[int, int, int, int], t2: Tuple[int, int, int, int], gap: int = 0
) -> bool:
    """True if two tile windows overlap or touch within ``gap`` pixels.

    Used to build the neighbor-tile adjacency graph for cross-tile merging
    (reference: mrcnn/sfinder.py:119-166).
    """
    x1min, x1max, y1min, y1max = t1
    x2min, x2max, y2min, y2max = t2
    return not (
        x1max + gap <= x2min
        or x2max + gap <= x1min
        or y1max + gap <= y2min
        or y2max + gap <= y1min
    )
