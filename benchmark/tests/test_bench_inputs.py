"""The frozen traffic generators (``benchmark/inputs.py``) write what
``chip_smoke.py``'s originals write, seed for seed, and a seed beyond 32
bits is taken."""

import json
import os
import sys

import numpy as np

from benchmark import inputs
from caesar_mrcnn_tpu_torch.utils.fits import read_fits_data

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_mosaic_and_tiles_equal_chip_smokes(tmp_path):
    ours, theirs = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    inputs.write_mosaic(ours, n=256, seed=7)
    chip_smoke.write_mosaic(theirs, n=256, seed=7)
    assert np.array_equal(read_fits_data(ours)[0], read_fits_data(theirs)[0])
    tiles = inputs.read_tiles(ours, 256, 128)
    assert tiles.shape == (4, 128, 128) and tiles.dtype == np.uint8
    assert np.array_equal(tiles, chip_smoke.read_tiles(theirs, 256, 128))


def test_mosaic_takes_a_seed_beyond_32_bits(tmp_path):
    a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    inputs.write_mosaic(a, n=128, seed=2**31 + 77, sources=4)
    inputs.write_mosaic(b, n=128, seed=2**31 + 77, sources=4)
    assert np.array_equal(read_fits_data(a)[0], read_fits_data(b)[0])


def test_train_dataset_equals_chip_smokes(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = inputs.write_train_dataset(str(tmp_path / "a"), n_images=2, size=64, objects=3, seed=4)
    theirs = chip_smoke.write_train_dataset(str(tmp_path / "b"), n_images=2, size=64, objects=3, seed=4)
    for p, q in zip(ours, theirs):
        dp, dq = json.load(open(p)), json.load(open(q))
        assert np.array_equal(read_fits_data(dp["img"])[0], read_fits_data(dq["img"])[0])
        assert [o["class"] for o in dp["objs"]] == [o["class"] for o in dq["objs"]]
        for op, oq in zip(dp["objs"], dq["objs"]):
            assert np.array_equal(read_fits_data(op["mask"])[0], read_fits_data(oq["mask"])[0])
    ds = inputs.load_train_dataset(ours)
    assert len(ds.image_ids) == 2
