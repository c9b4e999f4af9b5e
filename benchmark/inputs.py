"""Seeded inputs of the cells: radio-looking FITS mosaics cut into u8
tiles, and FITS training sets in ``SourceDataset``'s json layout.

Frozen copies of ``chip_smoke.py``'s ``write_mosaic``, ``read_tiles``,
``write_train_dataset`` and ``load_train_dataset``: the seed is the only
argument that changes the data, and a change to ``chip_smoke.py`` cannot
move the benchmark's traffic. The files go through the port's own FITS
writer, and the tiles through its reader and zscale, as the ``detect``
run mode reads a mosaic.
"""

from __future__ import annotations

import json
import os

import numpy as np

CLASS_NAMES = ("bkg", "sidelobe", "source", "galaxy")


def numpy_seed(seed: int) -> int:
    """``np.random.RandomState`` takes seeds below 2**32."""
    return int(seed) % (1 << 32)


def write_mosaic(path: str, n: int = 2048, seed: int = 0, sources: int = 0) -> None:
    """Radio-looking n x n FITS mosaic: noise plus gaussian sources
    (``sources``, or n / 16 of them)."""
    from caesar_mrcnn_tpu_torch.utils.fits import write_fits

    rng = np.random.RandomState(numpy_seed(seed))
    img = rng.normal(0.0, 0.05, (n, n)).astype(np.float32)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    for _ in range(sources or n // 16):
        cy, cx = rng.randint(32, n - 32, 2)
        s = rng.uniform(2.0, 8.0)
        amp = rng.uniform(0.5, 20.0)
        img[cy - 32:cy + 32, cx - 32:cx + 32] += amp * np.exp(
            -(((yy - 32) ** 2 + (xx - 32) ** 2) / (2 * s * s))
        )
    write_fits(img, path, header={"BMAJ": 1.5e-3, "BMIN": 1.2e-3,
                                  "CDELT1": -2.8e-4, "CDELT2": 2.8e-4})


def read_tiles(path: str, n: int, size: int) -> np.ndarray:
    """The mosaic's size x size tiles without overlap, row by row, each read
    and zscaled to u8 by the port's tile reader: [T, size, size] u8."""
    from caesar_mrcnn_tpu_torch.utils.fits import read_tile_u8
    from caesar_mrcnn_tpu_torch.utils.tiles import generate_tiles

    tiles = []
    for x1, x2, y1, y2 in generate_tiles(0, n, 0, n, size, size):
        tile = read_tile_u8(path, x1, x2, y1, y2)
        if tile is None:
            raise RuntimeError(f"cannot read tile {(x1, x2, y1, y2)} of {path}")
        tiles.append(tile)
    return np.stack(tiles)


def write_train_dataset(root: str, n_images: int = 16, size: int = 256, objects: int = 12,
                        seed: int = 0) -> list:
    """Seeded FITS training set in ``SourceDataset``'s json layout: noise
    plus ``objects`` elliptical gaussian sources per image, each with its
    own FITS mask. Returns the json descriptors' paths, one per image."""
    from caesar_mrcnn_tpu_torch.utils.fits import write_fits

    rng = np.random.RandomState(numpy_seed(seed))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    paths = []
    for i in range(n_images):
        img = rng.normal(0.0, 0.05, (size, size)).astype(np.float32)
        objs = []
        for j in range(objects):
            cy, cx = rng.uniform(24, size - 24, 2)
            ry, rx = rng.uniform(4, 20, 2)
            r2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            img += rng.uniform(1.0, 20.0) * np.exp(-r2)
            mask_path = os.path.join(root, f"img{i}_obj{j}.fits")
            write_fits((r2 <= 1.0).astype(np.float32), mask_path)
            objs.append({"mask": mask_path, "class": CLASS_NAMES[1 + rng.randint(3)]})
        img_path = os.path.join(root, f"img{i}.fits")
        write_fits(img, img_path)
        paths.append(os.path.join(root, f"img{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"img": img_path, "objs": objs}, f)
    return paths


def load_train_dataset(paths):
    """The port's ``SourceDataset`` over the json descriptors."""
    from caesar_mrcnn_tpu_torch.data.dataset import SourceDataset

    ds = SourceDataset()
    ds.set_class_dict({name: i for i, name in enumerate(CLASS_NAMES) if i})
    for p in paths:
        if ds.load_data_from_json_file(p) != 0:
            raise RuntimeError(f"dataset: cannot load {p}")
    ds.prepare()
    return ds
