"""Minimal pure-Python FITS image reader/writer.

The port's copy of ``caesar_mrcnn_tpu/utils/fits.py``, unchanged in
behaviour (the port imports nothing of the JAX package).

Replaces the reference's astropy FITS layer (reference: mrcnn/utils.py:984-1163)
without the astropy dependency. Supports the subset the pipeline needs:

* primary-HDU image data, BITPIX 8/16/32/-32/-64, NAXIS 2 or 4 (``[0,0,y,x]``
  plane selection like reference: mrcnn/utils.py:1060-1066)
* BSCALE/BZERO scaling
* windowed (tile) reads that seek row ranges instead of materializing the
  full mosaic — the enabler of the tile-parallel detect path
  (reference behavior: mrcnn/utils.py:1051-1072, mrcnn/sfinder.py:181-195)
* header access as a dict, plus a linear WCS helper

The high-level :func:`read_fits` applies the astronomy preprocessing chain
(NaN fill -> zscale / bias-contrast stretch -> normalize -> gray->RGB)
with the same knob semantics as the reference (mrcnn/utils.py:1033-1163).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .. import logger
from .zscale import contrast_bias_stretch, zscale_stretch

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


def _parse_card(card: str):
    """Parse one 80-char header card -> (key, value) or (key, None)."""
    key = card[:8].strip()
    if not key or key in ("COMMENT", "HISTORY", "END"):
        return key, None
    if card[8:10] != "= ":
        return key, None
    rest = card[10:]
    # strip inline comment (outside of strings)
    if rest.lstrip().startswith("'"):
        # string value: find closing quote ('' escapes a quote)
        s = rest.lstrip()
        out = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return key, "".join(out).rstrip()
    if "/" in rest:
        rest = rest.split("/", 1)[0]
    rest = rest.strip()
    if rest in ("T", "F"):
        return key, rest == "T"
    try:
        if any(c in rest for c in ".EeDd") and not rest.lstrip("+-").isdigit():
            return key, float(rest.replace("D", "E").replace("d", "e"))
        return key, int(rest)
    except ValueError:
        return key, rest


def read_header(filename: str) -> Dict[str, object]:
    """Read the primary-HDU header into a dict
    (reference analogue: mrcnn/utils.py:989-1003)."""
    header: Dict[str, object] = {}
    with open(filename, "rb") as f:
        while True:
            block = f.read(BLOCK)
            if len(block) < BLOCK:
                raise IOError(f"truncated FITS header in {filename}")
            text = block.decode("ascii", errors="replace")
            done = False
            for i in range(0, BLOCK, CARD):
                card = text[i : i + CARD]
                key, value = _parse_card(card)
                if key == "END":
                    done = True
                    break
                if value is not None and key not in header:
                    header[key] = value
            if done:
                break
    return header


def _header_nblocks(filename: str) -> int:
    """Number of 2880-byte blocks occupied by the primary header."""
    n = 0
    with open(filename, "rb") as f:
        while True:
            block = f.read(BLOCK)
            n += 1
            if len(block) < BLOCK:
                raise IOError(f"truncated FITS header in {filename}")
            if b"END     " in block or block.rstrip().endswith(b"END"):
                # verify END is at a card boundary
                text = block.decode("ascii", errors="replace")
                if any(
                    text[i : i + CARD].startswith("END") and text[i:i+8].strip() == "END"
                    for i in range(0, BLOCK, CARD)
                ):
                    return n


def get_fits_size(filename: str) -> Optional[Tuple[int, int]]:
    """(nx, ny) from NAXIS1/NAXIS2 (reference: mrcnn/utils.py:1006-1030)."""
    try:
        header = read_header(filename)
    except Exception:
        logger.error("Cannot read image file: %s", filename)
        return None
    if "NAXIS1" not in header or "NAXIS2" not in header:
        logger.error("NAXIS1/NAXIS2 keyword missing in header!")
        return None
    return int(header["NAXIS1"]), int(header["NAXIS2"])


get_fits_header = read_header


def read_fits_data(
    filename: str,
    xmin: int = -1,
    xmax: int = -1,
    ymin: int = -1,
    ymax: int = -1,
) -> Tuple[np.ndarray, Dict[str, object]]:
    """Raw 2D float32 image plane (optionally a window) + header.

    Windowed reads seek only the requested rows so arbitrarily large mosaics
    never materialize in memory.
    """
    header = read_header(filename)
    naxis = int(header.get("NAXIS", 0))
    if naxis not in (2, 3, 4):
        raise IOError(f"unsupported NAXIS={naxis} in {filename}")
    nx = int(header["NAXIS1"])
    ny = int(header["NAXIS2"])
    # degenerate leading axes (e.g. [1, 1, ny, nx]) select plane [0, 0]
    # like the reference (mrcnn/utils.py:1060-1062)
    bitpix = int(header["BITPIX"])
    dtype = _BITPIX_DTYPE[bitpix]
    itemsize = dtype.itemsize
    data_start = _header_nblocks(filename) * BLOCK

    read_tile = xmin >= 0 and xmax >= 0 and ymin >= 0 and ymax >= 0
    if read_tile:
        if xmax <= xmin or ymax <= ymin:
            raise ValueError("tile max must be > min")
        xmin_c, xmax_c = max(0, xmin), min(nx, xmax)
        ymin_c, ymax_c = max(0, ymin), min(ny, ymax)
        rows = ymax_c - ymin_c
        # One contiguous read of the full-width row block, then a column
        # slice — rows are contiguous on disk, so this is a single
        # seek+read instead of one per row.
        with open(filename, "rb") as f:
            f.seek(data_start + ymin_c * nx * itemsize)
            block = np.frombuffer(
                f.read(rows * nx * itemsize), dtype=dtype
            ).reshape(rows, nx)
        data = np.ascontiguousarray(block[:, xmin_c:xmax_c])
    else:
        count = nx * ny
        with open(filename, "rb") as f:
            f.seek(data_start)
            data = np.frombuffer(f.read(count * itemsize), dtype=dtype).reshape(ny, nx)

    data = data.astype(np.float32)
    bscale = float(header.get("BSCALE", 1.0))
    bzero = float(header.get("BZERO", 0.0))
    if bscale != 1.0 or bzero != 0.0:
        data = data * bscale + bzero
    return data, header


def read_fits(
    filename: str,
    xmin: int = -1,
    xmax: int = -1,
    ymin: int = -1,
    ymax: int = -1,
    stretch: bool = True,
    normalize: bool = True,
    convert_to_rgb: bool = True,
    zscale_contrasts=(0.25, 0.25, 0.25),
    to_uint8: bool = True,
    stretch_biascontrast: bool = False,
    contrast: float = 1.0,
    bias: float = 0.5,
):
    """Read + preprocess a FITS image exactly like the reference chain
    (reference: mrcnn/utils.py:1033-1163).

    Returns ``(image, header)`` where image is ``[H, W, 3]`` (RGB mode) or
    ``[H, W]``; None on error.
    """
    zscale_contrasts = list(zscale_contrasts)
    if len(zscale_contrasts) != 3:
        logger.warning(
            "Size of input zscale_contrasts is !=3, using default (0.25,0.25,0.25)"
        )
        zscale_contrasts = [0.25, 0.25, 0.25]

    try:
        data, header = read_fits_data(filename, xmin, xmax, ymin, ymax)
    except Exception as ex:
        logger.error("Cannot read image file %s (%s)", filename, ex)
        return None

    data = nan_fill(data)

    channels = [data, data, data]
    if stretch:
        channels = [
            zscale_stretch(ch, zscale_contrasts[i]).astype(np.float32)
            for i, ch in enumerate(channels)
        ]
    if stretch_biascontrast:
        channels = [
            contrast_bias_stretch(ch, contrast, bias).astype(np.float32)
            for ch in channels
        ]
    if normalize or convert_to_rgb:
        channels = [normalize_img(ch).astype(np.float32) for ch in channels]

    if convert_to_rgb:
        image = gray2rgb(channels, to_uint8)
    else:
        image = channels[0]
    return image, header


def nan_fill(data: np.ndarray) -> np.ndarray:
    """NaN/inf -> finite-min fill (reference: mrcnn/utils.py:1085-1087)."""
    finite = np.isfinite(data)
    if not finite.all():
        fill = float(data[finite].min()) if finite.any() else 0.0
        data = np.where(finite, data, fill)
    return data


def preprocess_tile_u8(data: np.ndarray, contrast: float = 0.25) -> np.ndarray:
    """Single-channel fast path of the read_fits preprocessing chain:
    NaN fill -> zscale stretch -> normalize -> uint8, fused into one pass
    (native stretch_to_u8 when built).

    Bit-equivalent to ``read_fits(...)[0][..., 0]`` with the default knobs
    (equal per-channel contrasts, to_uint8) because (a) gray2rgb's three
    channels are then identical, and (b) normalize-after-zscale is the
    identity: the zscale vmax never exceeds the data max (it is clipped to
    the sample max), so some pixel clips to exactly 1.0 and the divide-by-
    max is a no-op. The 3-channel/many-pass host chain measured ~6x the
    host cost of this fused path (VERDICT r2 item 1).
    """
    from ..native import stretch_to_u8

    data = nan_fill(np.asarray(data, dtype=np.float32))
    try:
        from ..native import available, zscale_limits as native_limits

        if available():
            vmin, vmax = native_limits(data, contrast=contrast)
        else:
            from .zscale import zscale_limits

            vmin, vmax = zscale_limits(data, contrast=contrast)
    except ImportError:
        from .zscale import zscale_limits

        vmin, vmax = zscale_limits(data, contrast=contrast)
    return stretch_to_u8(data, vmin, vmax)


def read_tile_u8(
    filename: str,
    xmin: int = -1,
    xmax: int = -1,
    ymin: int = -1,
    ymax: int = -1,
    contrast: float = 0.25,
) -> Optional[np.ndarray]:
    """Windowed read + fused single-channel preprocessing (uint8 [H, W])."""
    try:
        data, _header = read_fits_data(filename, xmin, xmax, ymin, ymax)
    except Exception as ex:  # noqa: BLE001
        logger.error("Cannot read image file %s (%s)", filename, ex)
        return None
    return preprocess_tile_u8(data, contrast)


def read_tile_raw(
    filename: str,
    xmin: int = -1,
    xmax: int = -1,
    ymin: int = -1,
    ymax: int = -1,
    contrast: float = 0.25,
) -> Optional[Tuple[np.ndarray, Tuple[float, float]]]:
    """Windowed raw f32 read + host zscale-limit fit only — the per-pixel
    stretch/normalize/quantize runs on-device (Detector.dispatch_tiles_raw).
    Returns ``(raw_f32, (vmin, vmax))``."""
    try:
        data, _header = read_fits_data(filename, xmin, xmax, ymin, ymax)
    except Exception as ex:  # noqa: BLE001
        logger.error("Cannot read image file %s (%s)", filename, ex)
        return None
    # fill BEFORE the limit fit: read_fits computes zscale on filled data,
    # and the fill value shifts the sample distribution
    data = nan_fill(data)
    try:
        from ..native import available, zscale_limits as native_limits

        if available():
            vmin, vmax = native_limits(data, contrast=contrast)
        else:
            raise ImportError
    except ImportError:
        from .zscale import zscale_limits

        vmin, vmax = zscale_limits(data, contrast=contrast)
    return data, (vmin, vmax)


def normalize_img(data: np.ndarray) -> np.ndarray:
    """Divide by max (reference: mrcnn/utils.py:1182-1188); safe for max<=0."""
    m = float(np.max(data))
    if m == 0 or not math.isfinite(m):
        return np.zeros_like(data, dtype=np.float32)
    return (data / m).astype(np.float32)


def gray2rgb(channels, to_uint8: bool = True) -> np.ndarray:
    """Stack three [0,1] channels into an RGB image scaled to [0,255]
    (reference: mrcnn/utils.py:1190-1208)."""
    if to_uint8:
        chans = [np.array(np.round(c * 255.0), dtype=np.uint8) for c in channels]
    else:
        chans = [np.array(c * 255.0, dtype=np.float32) for c in channels]
    return np.stack(chans, axis=-1)


def crop_img(
    data: np.ndarray,
    x0: float,
    y0: float,
    dx: int,
    dy: int,
    stretch: bool = False,
    normalize: bool = False,
    convert_to_rgb: bool = False,
) -> np.ndarray:
    """Cutout of size (dx, dy) around (x0, y0) with the optional
    preprocessing chain (reference: mrcnn/utils.py:1211-1249)."""
    xmin = int(x0 - dx / 2)
    xmax = int(x0 + dx / 2)
    ymin = int(y0 - dy / 2)
    ymax = int(y0 + dy / 2)
    crop = np.array(data[ymin:ymax, xmin:xmax], dtype=np.float32)
    finite = np.isfinite(crop)
    if not finite.all():
        fill = float(crop[finite].min()) if finite.any() else 0.0
        crop = np.where(finite, crop, fill)
    if stretch:
        crop = zscale_stretch(crop).astype(np.float32)
    if normalize:
        crop = normalize_img(crop)
    if convert_to_rgb:
        if not normalize:
            crop = normalize_img(crop)
        crop = gray2rgb([crop, crop, crop])
    return crop


# ------------------------------------------------------------------ writer


def _format_card(key: str, value) -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.11E}"
    else:
        card = f"{key:<8}= '{str(value):<8}'"
    return card.ljust(CARD)[:CARD].encode("ascii")


def write_fits(data: np.ndarray, filename: str, header: Optional[Dict] = None) -> None:
    """Write a 2D FITS image (test fixtures + catalog cutouts).

    uint8 input is stored as BITPIX=8 (4x smaller — used for binary object
    masks at dataset scale); everything else is stored float32 (BITPIX=-32).
    """
    data = np.asarray(data)
    if data.dtype != np.uint8:
        data = data.astype(np.float32)
    assert data.ndim == 2
    bitpix = 8 if data.dtype == np.uint8 else -32
    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", data.shape[1]),
        _format_card("NAXIS2", data.shape[0]),
    ]
    for k, v in (header or {}).items():
        if k in ("SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "END"):
            continue
        try:
            cards.append(_format_card(str(k)[:8].upper(), v))
        except Exception:
            continue
    cards.append("END".ljust(CARD).encode("ascii"))
    head = b"".join(cards)
    head += b" " * (-len(head) % BLOCK)
    body = data.tobytes() if bitpix == 8 else data.astype(">f4").tobytes()
    body += b"\x00" * (-len(body) % BLOCK)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "wb") as f:
        f.write(head)
        f.write(body)


# ------------------------------------------------------------------ WCS-lite


class LinearWCS:
    """Linear sky<->pixel transform from CRPIX/CRVAL/CDELT (+optional CD).

    A small subset of FITS WCS sufficient for catalog output; the reference
    used ``astropy.wcs`` inside SFinder for source sky coordinates
    (reference: mrcnn/sfinder.py:336-444, 994-1211). Pixel coordinates are
    0-based here (FITS CRPIX is 1-based).
    """

    def __init__(self, header: Dict[str, object]):
        self.crpix1 = float(header.get("CRPIX1", 1.0))
        self.crpix2 = float(header.get("CRPIX2", 1.0))
        self.crval1 = float(header.get("CRVAL1", 0.0))
        self.crval2 = float(header.get("CRVAL2", 0.0))
        if "CD1_1" in header:
            self.cd = np.array(
                [
                    [float(header.get("CD1_1", 1.0)), float(header.get("CD1_2", 0.0))],
                    [float(header.get("CD2_1", 0.0)), float(header.get("CD2_2", 1.0))],
                ]
            )
        else:
            self.cd = np.diag(
                [float(header.get("CDELT1", 1.0)), float(header.get("CDELT2", 1.0))]
            )
        self.ctype1 = str(header.get("CTYPE1", ""))
        self.ctype2 = str(header.get("CTYPE2", ""))

    def pixel_to_world(self, x, y):
        """0-based pixel -> world (deg); RA axis scaled by cos(dec)."""
        dx = np.asarray(x, dtype=np.float64) - (self.crpix1 - 1.0)
        dy = np.asarray(y, dtype=np.float64) - (self.crpix2 - 1.0)
        w1 = self.cd[0, 0] * dx + self.cd[0, 1] * dy
        w2 = self.cd[1, 0] * dx + self.cd[1, 1] * dy
        dec = self.crval2 + w2
        cosd = np.cos(np.deg2rad(self.crval2))
        cosd = np.where(np.abs(cosd) < 1e-12, 1e-12, cosd)
        ra = self.crval1 + w1 / cosd
        return ra, dec

    def world_to_pixel(self, ra, dec):
        cosd = np.cos(np.deg2rad(self.crval2))
        w1 = (np.asarray(ra, dtype=np.float64) - self.crval1) * cosd
        w2 = np.asarray(dec, dtype=np.float64) - self.crval2
        inv = np.linalg.inv(self.cd)
        dx = inv[0, 0] * w1 + inv[0, 1] * w2
        dy = inv[1, 0] * w1 + inv[1, 1] * w2
        return dx + (self.crpix1 - 1.0), dy + (self.crpix2 - 1.0)
