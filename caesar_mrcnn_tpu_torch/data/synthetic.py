"""Radio-realistic synthetic survey generator.

The port's copy of ``caesar_mrcnn_tpu/data/synthetic.py``, with one change:
the beam-correlated noise is blurred by :func:`gaussian_blur` (numpy) in
place of ``cv2.GaussianBlur`` (the port does not use OpenCV). The blur
equals OpenCV's within a few float32 ulps; the random draws, and so every
object's mask, class and SNR, are the same for the same seed.

The reference's published 66.51% mAP was measured on a 16,439-image survey
of real 256^2 radio continuum cutouts with three object classes
(reference: scripts/run.py:116-118 dataset size,
Object-Detection-Metrics/results/results.txt quality numbers). That survey
is not redistributable, so quality runs here synthesize a survey with
matched physical characteristics:

* **beam-correlated noise** — white Gaussian noise convolved with an
  elliptical restoring beam (per-image beam 3.5-6 px FWHM), scaled to a
  per-image RMS drawn from a log-normal distribution;
* **compact sources** (class ``source``) — point sources convolved with
  the beam (i.e. elliptical Gaussians at exactly the beam shape), fluxes
  from a power-law-ish log-uniform SNR distribution down to SNR ~4;
* **extended radio galaxies** (class ``galaxy``) — a morphology mix of
  single extended ellipticals, edge-brightened double-lobe (FR-II-like)
  systems with optional compact cores and inter-lobe bridges, and bent
  triples;
* **sidelobes** (class ``sidelobe``) — imaging artifacts: faint elongated
  spokes radiating from bright (high-SNR) sources, plus occasional
  stand-alone arcs — deliberately confusable with faint extended sources
  (the reference's hardest class at AP 25.55%).

Ground-truth masks mimic a 2.5-sigma island segmentation of the noiseless
object image (what caesar-style source finding would produce), and the
writer emits the exact on-disk layout the json datalist loader consumes
(reference: scripts/run.py:470-540): per-image FITS + per-object uint8
mask FITS + json descriptor + a ``.dat`` list of descriptors.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

CLASSES = {"sidelobe": 1, "source": 2, "galaxy": 3}


def _gauss2d(
    size: int, cy: float, cx: float, sy: float, sx: float, angle: float
) -> np.ndarray:
    """Rotated elliptical Gaussian evaluated on a local window (cheap:
    only a +/-4 sigma bounding window is touched)."""
    ext = 4.0 * max(sy, sx)
    y0, y1 = int(max(0, cy - ext)), int(min(size, cy + ext + 1))
    x0, x1 = int(max(0, cx - ext)), int(min(size, cx + ext + 1))
    out = np.zeros((size, size), np.float32)
    if y1 <= y0 or x1 <= x0:
        return out
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    ca, sa = np.cos(angle), np.sin(angle)
    dy = (yy - cy) * ca + (xx - cx) * sa
    dx = -(yy - cy) * sa + (xx - cx) * ca
    out[y0:y1, x0:x1] = np.exp(-(dy * dy / (2 * sy * sy) + dx * dx / (2 * sx * sx)))
    return out


def _gauss_kernel(k: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(k, sigma)`` as float32: computed in float64,
    normalised to sum 1, then rounded."""
    x = np.arange(k) - (k - 1) / 2.0
    g = np.exp(-x * x / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, k: int, sigma_x: float, sigma_y: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigmaX=sigma_x, sigmaY=sigma_y)`` of a
    float32 image: the separable filter, rows first, in float32, with
    OpenCV's default border (reflect without repeating the edge pixel)."""
    kx, ky = _gauss_kernel(k, sigma_x), _gauss_kernel(k, sigma_y)
    r = k // 2
    h, w = img.shape
    padded = np.pad(img.astype(np.float32), r, mode="reflect")
    rows = np.zeros((h + 2 * r, w), np.float32)
    for i in range(k):
        rows += padded[:, i:i + w] * kx[i]
    out = np.zeros((h, w), np.float32)
    for i in range(k):
        out += rows[i:i + h] * ky[i]
    return out


class SkySimulator:
    """Samples one 2D radio map + per-object ground truth at a time.

    The sidelobe knobs control artifact frequency only (appearance is
    unchanged), so a sidelobe-heavy TRAIN split can rebalance the
    reference's hardest class while the TEST split keeps the default
    physics for cross-round comparability (VERDICT r2 item 3).
    """

    def __init__(
        self,
        size: int = 256,
        seed: int = 0,
        sidelobe_spoke_p: float = 0.6,
        sidelobe_src_snr: float = 40.0,
        sidelobe_arc_p: float = 0.25,
    ):
        self.size = size
        self.rng = np.random.RandomState(seed)
        self.sidelobe_spoke_p = sidelobe_spoke_p
        self.sidelobe_src_snr = sidelobe_src_snr
        self.sidelobe_arc_p = sidelobe_arc_p

    # ------------------------------------------------------------ pieces
    def _beam(self) -> Tuple[float, float, float]:
        """(sigma_maj, sigma_min, pa) in pixels for this image's beam."""
        r = self.rng
        fwhm = r.uniform(3.5, 6.0)  # px
        ratio = r.uniform(0.75, 1.0)
        s = fwhm / 2.3548
        return s, s * ratio, r.uniform(0, np.pi)

    def _noise(self, rms: float, beam) -> np.ndarray:
        """Beam-correlated Gaussian noise with the requested RMS."""
        sy, sx, _ = beam
        white = self.rng.normal(0.0, 1.0, (self.size, self.size)).astype(np.float32)
        k = int(2 * np.ceil(3 * max(sy, sx)) + 1)
        corr = gaussian_blur(white, k, sx, sy)
        corr *= rms / max(corr.std(), 1e-12)
        return corr

    def _compact(self, beam, rms: float):
        r = self.rng
        n = self.size
        cy, cx = r.uniform(8, n - 8, 2)
        snr = np.exp(r.uniform(np.log(4.0), np.log(300.0)))
        sy, sx, pa = beam
        blob = snr * rms * _gauss2d(n, cy, cx, sy, sx, pa)
        return blob, snr, (cy, cx)

    def _galaxy(self, beam, rms: float):
        r = self.rng
        n = self.size
        cy, cx = r.uniform(24, n - 24, 2)
        snr = np.exp(r.uniform(np.log(5.0), np.log(120.0)))
        peak = snr * rms
        kind = r.choice(["double", "single", "triple"], p=[0.45, 0.35, 0.20])
        img = np.zeros((n, n), np.float32)
        axis = r.uniform(0, np.pi)
        if kind == "single":
            s = r.uniform(5.0, 12.0)
            img += peak * _gauss2d(n, cy, cx, s, r.uniform(0.4, 1.0) * s, axis)
        else:
            sep = r.uniform(8.0, 26.0)
            npts = 2 if kind == "double" else 3
            # lobes along the jet axis, optionally bent
            bend = r.uniform(-0.4, 0.4) if kind == "triple" else 0.0
            offs = np.linspace(-0.5, 0.5, npts)
            for k, o in enumerate(offs):
                a = axis + bend * o
                ly = cy + sep * o * np.cos(a)
                lx = cx + sep * o * np.sin(a)
                s_l = r.uniform(2.5, 6.0)
                amp = peak * r.uniform(0.6, 1.0)
                img += amp * _gauss2d(n, ly, lx, s_l, r.uniform(0.5, 0.9) * s_l,
                                      a + r.uniform(-0.3, 0.3))
            if r.rand() < 0.5:  # compact core
                sy, sx, pa = beam
                img += peak * r.uniform(0.2, 0.6) * _gauss2d(n, cy, cx, sy, sx, pa)
            if kind == "double" and r.rand() < 0.4:  # faint bridge
                img += peak * r.uniform(0.1, 0.25) * _gauss2d(
                    n, cy, cx, sep * 0.5, r.uniform(1.5, 3.0), axis
                )
        return img, snr, (cy, cx)

    def _sidelobe_spokes(self, center, rms: float):
        """1-3 faint elongated spokes radiating from a bright source; each
        spoke is its own object (they are detected separately)."""
        r = self.rng
        n = self.size
        cy, cx = center
        out = []
        for _ in range(r.randint(1, 4)):
            ang = r.uniform(0, 2 * np.pi)
            dist = r.uniform(9.0, 22.0)
            sy = cy + dist * np.cos(ang)
            sx = cx + dist * np.sin(ang)
            if not (4 <= sy < n - 4 and 4 <= sx < n - 4):
                continue
            snr = np.exp(r.uniform(np.log(3.5), np.log(10.0)))
            s_long = r.uniform(4.0, 10.0)
            s_short = r.uniform(1.0, 2.0)
            # roughly tangential or radial orientation
            ori = ang + (0.0 if r.rand() < 0.5 else np.pi / 2) + r.uniform(-0.3, 0.3)
            blob = snr * rms * _gauss2d(n, sy, sx, s_long, s_short, ori)
            out.append((blob, snr))
        return out

    def _sidelobe_arc(self, rms: float):
        """Stand-alone arc artifact: a chain of small Gaussians on a circle
        segment."""
        r = self.rng
        n = self.size
        cy, cx = r.uniform(20, n - 20, 2)
        rad = r.uniform(10.0, 25.0)
        a0 = r.uniform(0, 2 * np.pi)
        alen = r.uniform(0.5, 1.6)
        snr = np.exp(r.uniform(np.log(3.5), np.log(9.0)))
        img = np.zeros((n, n), np.float32)
        for t in np.linspace(0.0, 1.0, 7):
            a = a0 + alen * t
            img = np.maximum(
                img,
                _gauss2d(n, cy + rad * np.cos(a), cx + rad * np.sin(a),
                         2.2, 1.2, a + np.pi / 2),
            )
        return snr * rms * img, snr

    # ------------------------------------------------------------ sample
    def sample(self) -> Tuple[np.ndarray, List[Dict]]:
        """One map. Returns (image [n,n] float32 'Jy', objects) where each
        object dict has ``mask`` (bool [n,n]), ``class`` and ``snr``."""
        r = self.rng
        beam = self._beam()
        rms = float(np.exp(r.normal(np.log(5e-5), 0.4)))  # ~50 uJy
        bkg = float(r.normal(0.0, 0.2 * rms))
        img = self._noise(rms, beam) + bkg
        objs: List[Dict] = []

        def add(blob: np.ndarray, cls: str, snr: float) -> None:
            # caesar-style island segmentation of the noiseless component
            mask = blob > max(2.5 * rms, 0.08 * blob.max())
            if mask.sum() < 5:
                return
            objs.append({"mask": mask, "class": cls, "snr": float(snr)})

        n_src = r.poisson(4.0)
        n_gal = r.poisson(1.2)
        if n_src + n_gal == 0:
            n_src = 1
        for _ in range(n_src):
            blob, snr, center = self._compact(beam, rms)
            img += blob
            add(blob, "source", snr)
            # bright sources spawn sidelobe artifacts
            if snr > self.sidelobe_src_snr and r.rand() < self.sidelobe_spoke_p:
                for sblob, ssnr in self._sidelobe_spokes(center, rms):
                    img += sblob
                    add(sblob, "sidelobe", ssnr)
        for _ in range(n_gal):
            blob, snr, _center = self._galaxy(beam, rms)
            img += blob
            add(blob, "galaxy", snr)
        if r.rand() < self.sidelobe_arc_p:
            blob, snr = self._sidelobe_arc(rms)
            img += blob
            add(blob, "sidelobe", snr)
        return img, objs


def write_survey(
    outdir: str,
    n_images: int,
    seed: int = 0,
    size: int = 256,
    prefix: str = "sky",
    progress_every: int = 0,
    **sim_kwargs,
) -> str:
    """Write a synthetic survey in the reference datalist layout and return
    the path of the ``.dat`` list of json descriptors
    (reference json schema: scripts/run.py:470-540). ``sim_kwargs`` are
    forwarded to :class:`SkySimulator` (e.g. the sidelobe-rate knobs)."""
    from ..utils import fits as F
    from .. import logger

    os.makedirs(outdir, exist_ok=True)
    sim = SkySimulator(size=size, seed=seed, **sim_kwargs)
    beam_maj, beam_min = 1.5e-3, 1.2e-3  # deg, nominal
    pix = 2.8e-4
    json_paths = []
    for i in range(n_images):
        img, objs = sim.sample()
        name = f"{prefix}{i:06d}"
        ipath = os.path.join(outdir, f"{name}.fits")
        F.write_fits(
            img, ipath,
            header={"BMAJ": beam_maj, "BMIN": beam_min,
                    "CDELT1": -pix, "CDELT2": pix,
                    "CRPIX1": size / 2, "CRPIX2": size / 2,
                    "CRVAL1": 180.0, "CRVAL2": -40.0},
        )
        desc_objs = []
        for k, o in enumerate(objs):
            mpath = os.path.join(outdir, f"{name}_m{k}.fits")
            F.write_fits(o["mask"].astype(np.uint8), mpath)
            ys, xs = np.where(o["mask"])
            border = int(
                ys.min() == 0 or xs.min() == 0
                or ys.max() == size - 1 or xs.max() == size - 1
            )
            desc_objs.append({
                "mask": os.path.basename(mpath),
                "class": o["class"],
                "name": f"{name}_obj{k}",
                "snr": round(o["snr"], 3),
                "nislands": 1,
                "sidelobe-mixed": 0,
                "sidelobe-near": int(o["class"] == "sidelobe"),
                "maxsize_beam": 2.0,
                "minsize_beam": 1.0,
                "border": border,
            })
        desc = {
            "img": os.path.basename(ipath),
            "telescope": "SYNTH",
            "bkg": 0.0,
            "rms": 5e-5,
            "bmaj": beam_maj, "bmin": beam_min,
            "dx": pix, "dy": pix,
            "nx": size, "ny": size,
            "objs": desc_objs,
        }
        jpath = os.path.join(outdir, f"{name}.json")
        with open(jpath, "w") as f:
            json.dump(desc, f)
        json_paths.append(jpath)
        if progress_every and (i + 1) % progress_every == 0:
            logger.info("synthetic survey: %d/%d images", i + 1, n_images)
    lst = os.path.join(outdir, "datalist.dat")
    with open(lst, "w") as f:
        f.write("\n".join(json_paths) + "\n")
    return lst
