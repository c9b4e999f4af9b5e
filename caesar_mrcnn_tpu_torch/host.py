"""Host modules the port shares with the JAX package, re-exported so that
a caller of the port imports only ``caesar_mrcnn_tpu_torch``.

The configuration, the FITS dataset, FITS reading and writing, and the
mosaic tiling are numpy host code that imports no JAX; the port reuses
them rather than copying them.
"""

from caesar_mrcnn_tpu.config import Config, detector_config, inference_config
from caesar_mrcnn_tpu.data.dataset import SourceDataset
from caesar_mrcnn_tpu.utils.fits import read_tile_u8, write_fits
from caesar_mrcnn_tpu.utils.tiles import generate_tiles

__all__ = [
    "Config", "SourceDataset", "detector_config", "generate_tiles", "inference_config",
    "read_tile_u8", "write_fits",
]
