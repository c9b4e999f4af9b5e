"""Dataset registry + the radio-source dataset with its three loaders.

The port's copy of ``caesar_mrcnn_tpu/data/dataset.py``, unchanged in behaviour
(the port imports nothing of the JAX package).

Behavioral re-implementation of the reference's ``Dataset`` base
(reference: mrcnn/utils.py:305-453) and ``SourceDataset``
(reference: scripts/run.py:246-815):

* ascii filelist rows ``img.fits,mask.fits,class_name``
  (reference: scripts/run.py:374-440);
* per-image json descriptors with multi-object masks, metadata and
  flag-based class renaming — ``extended`` + nislands>1 ->
  ``extended-multisland``, flagged -> ``flagged``
  (reference: scripts/run.py:445-592);
* recursive json directory search (reference: scripts/run.py:597-636);
* FITS multi-mask loading (reference: scripts/run.py:641-723);
* class-weight computation ``n / (k * n_c)`` (reference:
  scripts/run.py:785-815).
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import logger
from ..utils import fits as F

SOURCE = "rg-dataset"


class Dataset:
    """Registry of classes and images (reference: mrcnn/utils.py:305-453)."""

    def __init__(self):
        self._image_ids: np.ndarray = np.array([], dtype=np.int64)
        self.image_info: List[Dict] = []
        self.class_info: List[Dict] = [{"source": "", "id": 0, "name": "BG"}]
        self.source_class_ids: Dict[str, List[int]] = {}

    def add_class(self, source: str, class_id: int, class_name: str) -> None:
        assert "." not in source, "Source name cannot contain a dot"
        for info in self.class_info:
            if info["source"] == source and info["id"] == class_id:
                return
        self.class_info.append({"source": source, "id": class_id, "name": class_name})

    def add_image(self, source: str, image_id, path: Optional[str], **kwargs) -> None:
        info = {"id": image_id, "source": source, "path": path}
        info.update(kwargs)
        self.image_info.append(info)

    def prepare(self) -> None:
        """Build id maps (reference: mrcnn/utils.py:362-396)."""

        def clean_name(name):
            return ",".join(name.split(",")[:1])

        self.num_classes = len(self.class_info)
        self.class_ids = np.arange(self.num_classes)
        self.class_names = [clean_name(c["name"]) for c in self.class_info]
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)

        self.class_from_source_map = {
            f"{info['source']}.{info['id']}": cid
            for info, cid in zip(self.class_info, self.class_ids)
        }
        self.image_from_source_map = {
            f"{info['source']}.{info['id']}": iid
            for info, iid in zip(self.image_info, self._image_ids)
        }
        sources = list({i["source"] for i in self.class_info})
        self.source_class_ids = {}
        for source in sources:
            self.source_class_ids[source] = []
            for i, info in enumerate(self.class_info):
                if i == 0 or source == info["source"]:
                    self.source_class_ids[source].append(i)

    @property
    def image_ids(self):
        return self._image_ids

    def map_source_class_id(self, source_class_id: str) -> int:
        return self.class_from_source_map[source_class_id]

    def image_reference(self, image_id) -> str:
        return self.image_info[image_id].get("path", "") or ""

    # overridable loaders
    def load_image(self, image_id) -> np.ndarray:
        raise NotImplementedError

    def load_mask(self, image_id) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class SourceDataset(Dataset):
    """Radio-source dataset with FITS images + per-object FITS masks."""

    def __init__(self):
        super().__init__()
        self.class_id_map: Dict[str, int] = {}
        self.nclasses = 0
        self.loaded_imgs = 0
        # preprocessing knobs (reference: scripts/run.py:256-266, 729-750)
        self.convert_to_rgb = True
        self.apply_zscale = True
        self.zscale_contrasts = [0.25, 0.25, 0.25]
        self.convert_to_uint8 = True
        self.apply_biascontrast = False
        self.bias = 0.5
        self.contrast = 1.0
        self.nobjs_per_class: Dict[int, int] = {}
        self.class_weights: Dict[int, float] = {}

    # ------------------------------------------------------------ classes
    def set_class_dict(self, class_dict) -> int:
        """Set classes from a json string or dict
        (reference: scripts/run.py:272-315)."""
        if isinstance(class_dict, str):
            if not class_dict:
                logger.error("Empty class dict string given!")
                return -1
            try:
                class_dict = json.loads(class_dict)
            except Exception:
                logger.error("Failed to parse class dictionary from string!")
                return -1
        self.class_id_map = dict(class_dict)
        for class_name, class_id in self.class_id_map.items():
            self.add_class(SOURCE, class_id, class_name)
            self.nobjs_per_class[class_id] = 0
        self.class_id_map["bkg"] = 0
        self.nobjs_per_class[0] = 0
        self.nclasses = len(self.class_id_map)
        return 0

    # ------------------------------------------------------------- loaders
    def load_data_from_list(self, dataset: str, nmaximgs: int = -1) -> int:
        """ascii rows ``img,mask,class_name`` (reference: scripts/run.py:374-440)."""
        img_counter = 0
        status = 0
        with open(dataset, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",")
                if len(parts) != 3:
                    logger.warning("Malformed row '%s', skipping", line)
                    status = -1
                    continue
                filename, filename_mask, class_name = parts
                fp = os.path.abspath(filename)
                mp = os.path.abspath(filename_mask)
                if not (os.path.isfile(fp) and fp.endswith(".fits")):
                    logger.warning("Image file %s invalid, skipping", filename)
                    status = -1
                    continue
                if not (os.path.isfile(mp) and mp.endswith(".fits")):
                    logger.warning("Mask file %s invalid, skipping", filename_mask)
                    status = -1
                    continue
                if class_name not in self.class_id_map:
                    logger.warning("Class %s unknown, skipping %s", class_name, filename)
                    status = -1
                    continue
                class_id = self.class_id_map[class_name]
                self.add_image(
                    SOURCE,
                    image_id=str(uuid.uuid1()),
                    path=fp,
                    path_masks=[mp],
                    class_ids=[class_id],
                )
                self.nobjs_per_class[class_id] += 1
                img_counter += 1
                self.loaded_imgs += 1
                if nmaximgs != -1 and img_counter >= nmaximgs:
                    break
        if img_counter <= 0:
            logger.error("All files in list have been skipped!")
            return -1
        logger.info("#%d images added in dataset", img_counter)
        return status

    def load_data_from_json_file(
        self, filename: str, rootdir: str = "", modify_class_names: bool = True
    ) -> int:
        """Per-image json descriptor (reference: scripts/run.py:445-552)."""
        try:
            with open(filename, "r") as jf:
                d = json.load(jf)
        except IOError:
            logger.error("Failed to open file %s, skipping", filename)
            return -1

        img_fullpath = os.path.abspath(os.path.join(rootdir, d["img"]))
        if not (os.path.isfile(img_fullpath) and img_fullpath.endswith(".fits")):
            logger.warning("Image file %s invalid, skipping", img_fullpath)
            return -1

        img_metadata = {
            k: d.get(k) for k in ("telescope", "bkg", "rms", "bmaj", "bmin", "dx", "dy", "nx", "ny")
        }

        mask_paths: List[str] = []
        class_ids: List[int] = []
        sidelobes_mixed_or_near: List[int] = []
        for obj in d.get("objs", []):
            mask_fullpath = os.path.abspath(os.path.join(rootdir, obj["mask"]))
            if not (os.path.isfile(mask_fullpath) and mask_fullpath.endswith(".fits")):
                logger.error("Mask %s of %s invalid", mask_fullpath, img_fullpath)
                return -1
            is_flagged = obj.get("sidelobe-mixed", 0)
            nislands = obj.get("nislands", 1)
            class_name = obj["class"]
            # flag-based class renaming (reference: scripts/run.py:505-512)
            if modify_class_names:
                if nislands > 1 and class_name == "extended":
                    class_name = "extended-multisland"
                if is_flagged:
                    class_name = "flagged"
                obj["class"] = class_name
            if class_name not in self.class_id_map:
                logger.warning(
                    "Class %s of %s not in dictionary, skipping object",
                    class_name,
                    img_fullpath,
                )
                continue
            smon = 0
            if "sidelobe-mixed" in obj and "sidelobe-near" in obj:
                if obj["sidelobe-mixed"] == 1 or obj["sidelobe-near"] == 1:
                    smon = 1
            mask_paths.append(mask_fullpath)
            class_ids.append(self.class_id_map[class_name])
            sidelobes_mixed_or_near.append(smon)

        self.add_image(
            SOURCE,
            image_id=str(uuid.uuid1()),
            path=img_fullpath,
            path_masks=mask_paths,
            class_ids=class_ids,
            sidelobes_mixed_or_near=sidelobes_mixed_or_near,
            objs=d.get("objs", []),
            metadata=img_metadata,
        )
        for cid in class_ids:
            self.nobjs_per_class[cid] += 1
        return 0

    def load_data_from_json_list(self, filelist: str, nmaximgs: int = -1) -> int:
        """ascii list of json descriptor paths (reference: scripts/run.py:556-592)."""
        img_counter = 0
        with open(filelist, "r") as f:
            for filename in f:
                filename = filename.strip()
                if not filename:
                    continue
                rootdir = os.path.dirname(filename) if os.path.isabs(filename) else ""
                if self.load_data_from_json_file(filename, rootdir) < 0:
                    continue
                img_counter += 1
                self.loaded_imgs += 1
                if nmaximgs != -1 and img_counter >= nmaximgs:
                    break
        if img_counter <= 0:
            logger.error("All files in list have been skipped!")
            return -1
        return 0

    def load_data_from_json_search(self, topdir: str, nmaximgs: int = -1) -> int:
        """Recursive json search (reference: scripts/run.py:597-636)."""
        if not os.path.isdir(topdir):
            logger.error("Directory %s does not exist!", topdir)
            return -1
        img_counter = 0
        for root, _dirs, files in os.walk(topdir):
            for filename in sorted(files):
                if not filename.endswith(".json"):
                    continue
                if self.load_data_from_json_file(os.path.join(root, filename), root) < 0:
                    continue
                img_counter += 1
                self.loaded_imgs += 1
                if nmaximgs != -1 and img_counter >= nmaximgs:
                    return 0
        return 0

    # ------------------------------------------------------------- access
    def load_image(self, image_id) -> np.ndarray:
        """FITS image with the configured preprocessing chain
        (reference: scripts/run.py:729-750)."""
        filename = self.image_info[image_id]["path"]
        out = F.read_fits(
            filename,
            stretch=self.apply_zscale,
            zscale_contrasts=self.zscale_contrasts,
            normalize=True,
            convert_to_rgb=self.convert_to_rgb,
            to_uint8=self.convert_to_uint8,
            stretch_biascontrast=self.apply_biascontrast,
            bias=self.bias,
            contrast=self.contrast,
        )
        if out is None:
            raise IOError(f"cannot read {filename}")
        image = out[0]
        if image.ndim == 2:  # grayscale mode: add the channel axis
            image = image[..., None]
        return image

    def load_mask(self, image_id) -> Tuple[np.ndarray, np.ndarray]:
        """Stack per-object binary FITS masks (reference: scripts/run.py:697-723)."""
        info = self.image_info[image_id]
        filenames = info["path_masks"]
        class_ids = info["class_ids"]
        mask = None
        for i, filename in enumerate(filenames):
            out = F.read_fits(filename, stretch=False, normalize=False, convert_to_rgb=False)
            if out is None:
                raise IOError(f"cannot read mask {filename}")
            data = out[0].astype(bool)
            if mask is None:
                mask = np.zeros(data.shape + (len(filenames),), dtype=bool)
            mask[:, :, i] = data
        if mask is None:
            mask = np.zeros((0, 0, 0), dtype=bool)
        return mask, np.array(class_ids, dtype=np.int32)

    def load_gt_masks(self, image_id, binary: bool = True) -> Optional[np.ndarray]:
        """Raw GT mask stack (reference: scripts/run.py:641-668)."""
        info = self.image_info[image_id]
        filenames = info["path_masks"]
        mask = None
        for i, filename in enumerate(filenames):
            out = F.read_fits(filename, stretch=False, normalize=False, convert_to_rgb=False)
            data = out[0]
            data = data.astype(bool) if binary else data.astype(np.int64)
            if mask is None:
                mask = np.zeros(
                    data.shape + (len(filenames),), dtype=bool if binary else np.int64
                )
            mask[:, :, i] = data
        return mask

    def load_gt_obj_info(self, image_id) -> List[Dict]:
        info = self.image_info[image_id]
        return info.get("objs", [])

    def image_uuid(self, image_id):
        return self.image_info[image_id]["id"]

    def image_metadata(self, image_id) -> Dict:
        return self.image_info[image_id].get("metadata", {})

    def compute_class_weights(self) -> int:
        """``w_c = n / (k * n_c)`` over non-empty classes
        (reference: scripts/run.py:785-815)."""
        if not self.nobjs_per_class:
            logger.warning("No objects-per-class info; cannot compute weights")
            return -1
        nclasses = sum(1 for v in self.nobjs_per_class.values() if v > 0)
        nobjs = sum(v for v in self.nobjs_per_class.values() if v > 0)
        for k, v in self.nobjs_per_class.items():
            self.class_weights[k] = 1.0 if v <= 0 else float(nobjs) / (nclasses * float(v))
        return 0


def create_train_val_sets_from_list(
    data: Sequence[str],
    crossval_size: float = 0.1,
    train_filename: str = "train.dat",
    crossval_filename: str = "crossval.dat",
    seed: Optional[int] = None,
) -> Tuple[str, str]:
    """Shuffle rows and split into train/val list files
    (reference: scripts/run.py:821-848)."""
    data = list(data)
    rng = np.random.RandomState(seed)
    rng.shuffle(data)
    n_val = max(1, int(round(len(data) * crossval_size))) if len(data) > 1 else 0
    val, train = data[:n_val], data[n_val:]
    with open(train_filename, "w") as f:
        for row in train:
            f.write(row.rstrip("\n") + "\n")
    with open(crossval_filename, "w") as f:
        for row in val:
            f.write(row.rstrip("\n") + "\n")
    return train_filename, crossval_filename
