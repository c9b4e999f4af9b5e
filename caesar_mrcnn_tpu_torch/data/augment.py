"""Geometric augmentations applied jointly to image + instance masks.

The port's copy of ``caesar_mrcnn_tpu/data/augment.py``, unchanged in behaviour
(the port imports nothing of the JAX package).

Numpy re-implementation of the reference's imgaug pipeline
``SomeOf((0, 2), [Fliplr, Flipud, Rotate(90), Rotate(-90),
Affine(translate_percent=+-0.3)])`` (reference: scripts/run.py:1090-1100),
without the imgaug dependency.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


def _fliplr(img, mask):
    return np.fliplr(img), np.fliplr(mask)


def _flipud(img, mask):
    return np.flipud(img), np.flipud(mask)


def _rot90(img, mask):
    return np.rot90(img, 1, axes=(0, 1)).copy(), np.rot90(mask, 1, axes=(0, 1)).copy()


def _rot270(img, mask):
    return np.rot90(img, 3, axes=(0, 1)).copy(), np.rot90(mask, 3, axes=(0, 1)).copy()


def _make_translate(rng: np.random.RandomState):
    tx = rng.uniform(-0.3, 0.3)
    ty = rng.uniform(-0.3, 0.3)

    def translate(img, mask):
        h, w = img.shape[:2]
        dy, dx = int(round(ty * h)), int(round(tx * w))

        def shift(a):
            out = np.zeros_like(a)
            ys = slice(max(dy, 0), h + min(dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            ys_src = slice(max(-dy, 0), h + min(-dy, 0))
            xs_src = slice(max(-dx, 0), w + min(-dx, 0))
            out[ys, xs] = a[ys_src, xs_src]
            return out

        return shift(img), shift(mask)

    return translate


def augment_image_and_mask(
    image: np.ndarray, mask: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply 0-2 randomly chosen ops (order randomized like SomeOf)."""
    rng = rng or np.random.RandomState()
    ops: List[Callable] = [_fliplr, _flipud, _rot90, _rot270, _make_translate(rng)]
    n = rng.randint(0, 3)  # 0, 1 or 2 ops
    chosen = rng.choice(len(ops), size=n, replace=False)
    for i in chosen:
        image, mask = ops[i](image, mask)
    return image, mask
