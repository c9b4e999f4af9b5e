"""Training data pipeline without jax or cv2 (port of
``caesar_mrcnn_tpu/data/generator.py``).

:func:`load_image_gt` loads, resizes, augments and masks one image;
:class:`TrainingPipeline` is the infinite shuffled batch stream with RPN
targets, GT subsampling to ``max_gt_instances`` and a skip-on-error budget
of 5, and its threaded prefetch (``TrainingPipeline.prefetch``), which
copies each batch to the card on the producer's side in place of
``jax.device_put``. Batches are numpy dicts with static shapes, in the wire of
``config.train_wire`` that ``train.trainer.mold_batch`` molds on the
device. Datasets, augmentations, anchors and FITS reading are the port's
copies of the JAX package's modules (``data.dataset``, ``data.augment``,
``utils.anchors``, ``utils.fits``); resizes and meta are the port's own
(``utils.image``, ``models.meta``), so the mini-mask resize follows torch's
bilinear rounding where cv2's differs (``utils.image.minimize_mask``).
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.meta import compose_image_meta
from ..models.targets import build_rpn_targets
from ..utils import boxes as B
from ..utils import image as I
from ..utils.anchors import generate_pyramid_anchors
from .augment import augment_image_and_mask
from .dataset import Dataset

log = logging.getLogger(__name__)

# how often a pipeline thread blocked on a queue looks at its stop event
_POLL_S = 0.1


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> device tensors: pinned and copied
    asynchronously to a CUDA device. Tensors already there pass through."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if cuda and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=cuda)
    return out


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """``q.put(item)`` unless ``stop`` is set first; True when put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            pass
    return False


def _get(q: "queue.Queue", stop: threading.Event):
    """``q.get()``, or None once ``stop`` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            pass
    return None


def load_resized(dataset: Dataset, config: Config, image_id: int):
    """Deterministic load + resize stage of :func:`load_image_gt`. Returns
    (image, original_shape, window, scale, mask, class_ids)."""
    image = dataset.load_image(image_id)
    mask, class_ids = dataset.load_mask(image_id)
    original_shape = image.shape
    image, window, scale, padding, _ = I.resize_image(
        image,
        min_dim=config.image_min_dim,
        min_scale=config.image_min_scale,
        max_dim=config.image_max_dim,
        mode=config.image_resize_mode,
    )
    mask = I.resize_mask(mask, scale, padding)
    return image, original_shape, window, scale, mask, class_ids


def load_image_gt(
    dataset: Dataset,
    config: Config,
    image_id: int,
    augmentation: bool = False,
    use_mini_mask: bool = False,
    rng: Optional[np.random.RandomState] = None,
    _loaded=None,
):
    """Load one image and its GT: (image, image_meta, class_ids, bbox,
    mask), unpadded. ``_loaded`` is a precomputed :func:`load_resized`
    result (the pipeline's cross-epoch cache)."""
    rng = rng or np.random.RandomState()
    image, original_shape, window, scale, mask, class_ids = (
        _loaded if _loaded is not None else load_resized(dataset, config, image_id)
    )
    if augmentation:
        image, mask = augment_image_and_mask(image, mask, rng)

    # drop instances whose mask vanished
    idx = mask.any(axis=0).any(axis=0)
    mask = mask[:, :, idx]
    class_ids = class_ids[idx]
    bbox = B.extract_bboxes(mask)

    active_class_ids = np.zeros([dataset.num_classes], dtype=np.int32)
    source_class_ids = dataset.source_class_ids[dataset.image_info[image_id]["source"]]
    active_class_ids[source_class_ids] = 1

    if use_mini_mask and len(class_ids):
        mask = I.minimize_mask(bbox, mask, config.mini_mask_shape)

    image_meta = compose_image_meta(
        image_id, original_shape, image.shape, window, scale, active_class_ids
    )
    return image, image_meta, class_ids, bbox, mask


class TrainingPipeline:
    """Infinite batched sample stream with static shapes.

    ``cache_bytes`` > 0 keeps the load + resize stage of up to that many
    bytes of images across epochs (one u8 plane for replicated-channel
    images, bit-packed masks; least recently used out first).
    ``num_workers`` sample threads and a queue of ``max_queue`` batches
    serve :meth:`prefetch`.
    """

    def __init__(
        self,
        dataset: Dataset,
        config: Config,
        shuffle: bool = True,
        augmentation: bool = False,
        seed: Optional[int] = None,
        num_workers: int = 0,
        max_queue: int = 16,
        cache_bytes: int = 0,
    ):
        self.dataset = dataset
        self.config = config
        self.shuffle = shuffle
        self.augmentation = augmentation
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.max_queue = max_queue
        self._cache_budget = int(cache_bytes)
        self._cache: "OrderedDict[int, Tuple[tuple, int]]" = OrderedDict()
        self._cache_used = 0
        self._cache_lock = threading.Lock()  # the prefetch's sample threads share the cache
        self.anchors = generate_pyramid_anchors(
            config.rpn_anchor_scales,
            config.rpn_anchor_ratios,
            config.backbone_shapes,
            config.backbone_strides,
            config.rpn_anchor_stride,
        )
        self.mask_hw = (
            tuple(config.mini_mask_shape) if config.use_mini_mask else tuple(config.image_shape[:2])
        )
        # Mono image wire: one channel when every image's channels are
        # replicas by construction (gray -> RGB with one zscale contrast and
        # no bias-contrast stretch); mold_batch broadcasts back.
        contrasts = list(getattr(dataset, "zscale_contrasts", [0.25]))
        self._mono_wire = bool(
            config.train_wire == "compact"
            and config.image_shape[2] > 1
            and getattr(dataset, "convert_to_rgb", False)
            and not getattr(dataset, "apply_biascontrast", False)
            and len(set(contrasts)) <= 1
        )

    def anchors_normalized(self) -> np.ndarray:
        """Pyramid anchors in normalized coordinates for the device graph."""
        return B.norm_boxes(self.anchors, self.config.image_shape[:2])

    # -------------------------------------------------------------- cache
    @staticmethod
    def _cache_pack(loaded):
        image, original_shape, window, scale, mask, class_ids = loaded
        if mask.dtype != bool:
            return None  # only binary masks are bit-packed
        mono = (
            image.ndim == 3
            and image.shape[2] > 1
            and np.array_equal(image[..., 0], image[..., 1])
            and np.array_equal(image[..., 0], image[..., -1])
        )
        img_store = np.ascontiguousarray(image[..., :1]) if mono else image
        mbits = np.packbits(mask, axis=None)
        for arr in (img_store, mbits, class_ids):  # handed out by reference
            arr.flags.writeable = False
        entry = (img_store, image.shape, original_shape, window, scale, mbits, mask.shape, class_ids)
        return entry, img_store.nbytes + mbits.nbytes + class_ids.nbytes + 256

    @staticmethod
    def _cache_unpack(entry):
        img_store, img_shape, original_shape, window, scale, mbits, mshape, cls = entry
        image = img_store if img_store.shape == img_shape else np.repeat(img_store, img_shape[2], axis=2)
        mask = np.unpackbits(mbits, count=int(np.prod(mshape))).reshape(mshape).view(bool)
        return image, original_shape, window, scale, mask, cls

    def _load_resized(self, image_id: int):
        if self._cache_budget <= 0:
            return load_resized(self.dataset, self.config, image_id)
        with self._cache_lock:
            hit = self._cache.get(image_id)
            if hit is not None:
                self._cache.move_to_end(image_id)
        if hit is not None:
            return self._cache_unpack(hit[0])
        loaded = load_resized(self.dataset, self.config, image_id)
        packed = self._cache_pack(loaded)
        if packed is not None:
            with self._cache_lock:
                if image_id not in self._cache:
                    self._cache[image_id] = packed
                    self._cache_used += packed[1]
                    while self._cache_used > self._cache_budget and len(self._cache) > 1:
                        _, (_, old_bytes) = self._cache.popitem(last=False)
                        self._cache_used -= old_bytes
        return loaded

    # ------------------------------------------------------------- sample
    def make_sample(self, image_id: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        cfg = self.config
        rng = rng if rng is not None else self.rng
        image, meta, class_ids, bbox, mask = load_image_gt(
            self.dataset, cfg, image_id,
            augmentation=self.augmentation,
            use_mini_mask=cfg.use_mini_mask,
            rng=rng,
            _loaded=self._load_resized(image_id),
        )
        rpn_match, rpn_deltas = build_rpn_targets(self.anchors, class_ids, bbox, cfg, rng)

        g = cfg.max_gt_instances
        if class_ids.shape[0] > g:
            ids = rng.choice(np.arange(class_ids.shape[0]), g, replace=False)
            class_ids, bbox, mask = class_ids[ids], bbox[ids], mask[:, :, ids]

        h, w = cfg.image_shape[:2]
        gt_ids = np.zeros((g,), np.int32)
        gt_boxes = np.zeros((g, 4), np.float32)
        mh, mw = self.mask_hw
        gt_masks = np.zeros((mh, mw, g), np.uint8)
        n = class_ids.shape[0]
        if n:
            gt_ids[:n] = class_ids
            gt_boxes[:n] = B.norm_boxes(bbox.astype(np.float32), (h, w))
            gt_masks[:, :, :n] = mask.astype(np.uint8)

        if cfg.train_wire == "compact":
            # RPN targets as index lists + per-positive deltas (pad index A),
            # bit-packed masks, and one channel for replicated-channel images
            a = rpn_match.shape[0]
            budget = cfg.rpn_train_anchors_per_image
            pos = np.flatnonzero(rpn_match == 1)
            neg = np.flatnonzero(rpn_match == -1)
            pos_idx = np.full((budget // 2,), a, np.int32)
            pos_idx[: len(pos)] = pos
            neg_idx = np.full((budget,), a, np.int32)
            neg_idx[: len(neg)] = neg
            pos_deltas = np.zeros((budget // 2, 4), np.float32)
            pos_deltas[: len(pos)] = rpn_deltas[pos]
            img_wire = image
            if self._mono_wire and image.ndim == 3 and image.shape[2] > 1:
                img_wire = np.ascontiguousarray(image[..., :1])
            sample = {
                "images": img_wire,
                "image_meta": meta.astype(np.float32),
                "rpn_pos_idx": pos_idx,
                "rpn_neg_idx": neg_idx,
                "rpn_pos_deltas": pos_deltas,
                "gt_class_ids": gt_ids,
                "gt_boxes": gt_boxes,
                "gt_masks_packed": np.packbits(gt_masks, axis=None),
            }
        else:
            sample = {
                "images": image,
                "image_meta": meta.astype(np.float32),
                "rpn_match": rpn_match.astype(np.int8),
                "rpn_deltas": rpn_deltas.astype(np.float32),
                "gt_class_ids": gt_ids,
                "gt_boxes": gt_boxes,
                "gt_masks": gt_masks,
            }
        if not cfg.use_rpn_rois:
            # head-only training on generated ROIs (ext_rois)
            from ..models.debug_rois import generate_random_rois

            rois_px = generate_random_rois((h, w), cfg.post_nms_rois_training, bbox, rng)
            sample["rois"] = B.norm_boxes(rois_px.astype(np.float32), (h, w))
        return sample

    # -------------------------------------------------------------- batches
    def _id_stream(self) -> Iterator[int]:
        ids = np.copy(self.dataset.image_ids)
        while True:
            if self.shuffle:
                self.rng.shuffle(ids)
            yield from ids

    def batches(self, batch_size: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite batch iterator; gives up after 5 failed samples in a row."""
        bs = batch_size or self.config.batch_size
        stream = self._id_stream()
        error_count = 0
        while True:
            batch = []
            while len(batch) < bs:
                image_id = next(stream)
                try:
                    batch.append(self.make_sample(image_id))
                    error_count = 0
                except Exception:  # noqa: BLE001 - a bad sample is skipped, up to the budget
                    log.exception("Error processing image %s", self.dataset.image_reference(image_id))
                    error_count += 1
                    if error_count > 5:
                        raise
            yield {k: np.stack([s[k] for s in batch]) for k in batch[0]}

    def prefetch(self, batch_size: Optional[int] = None, device=None) -> Iterator[Dict]:
        """Batches made ahead by background threads, through a queue of
        ``max_queue`` batches. With ``device`` (a CUDA device) each batch
        is pinned and copied to it asynchronously on the producer's side
        (:func:`batch_to_device`); without, batches stay numpy.

        With ``num_workers <= 1`` one thread runs :meth:`batches`, in its
        order. With more, an id feeder, ``num_workers`` sample threads (FITS
        IO, the native zscale and numpy release the GIL), each with its own
        ``RandomState`` seeded from the pipeline's, and an assembler build
        them, so the order of the samples is not fixed. An exception in any
        thread is raised here; closing the iterator stops the threads.
        """
        bs = batch_size or self.config.batch_size
        q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        stop = threading.Event()
        threads = []

        def put_batches(batch_iter):
            try:
                for batch in batch_iter:
                    if stop.is_set():
                        return
                    if device is not None:
                        batch = batch_to_device(batch, device)
                    if not _put(q, batch, stop):
                        return
            except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                _put(q, e, stop)

        if self.num_workers <= 1:
            threads.append(threading.Thread(target=put_batches, args=(self.batches(bs),), daemon=True))
        else:
            id_q: "queue.Queue" = queue.Queue(maxsize=4 * bs)
            sample_q: "queue.Queue" = queue.Queue(maxsize=4 * bs)
            stream = self._id_stream()
            seeds = self.rng.randint(2 ** 31, size=self.num_workers)

            def id_feeder():
                for image_id in stream:
                    if not _put(id_q, image_id, stop):
                        return

            def sample_worker(seed):
                rng = np.random.RandomState(seed)  # RandomState is not thread-safe
                error_count = 0
                while True:
                    image_id = _get(id_q, stop)
                    if image_id is None:
                        return
                    try:
                        sample = self.make_sample(image_id, rng=rng)
                        error_count = 0
                    except Exception as e:  # noqa: BLE001 - a bad sample is skipped, up to the budget
                        log.exception("Error processing image %s", self.dataset.image_reference(image_id))
                        error_count += 1
                        if error_count > 5:
                            _put(sample_q, e, stop)
                            return
                        continue
                    if not _put(sample_q, sample, stop):
                        return

            def assembled():
                while True:
                    samples = []
                    while len(samples) < bs:
                        item = _get(sample_q, stop)
                        if item is None:
                            return
                        if isinstance(item, Exception):
                            raise item
                        samples.append(item)
                    yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}

            threads.append(threading.Thread(target=id_feeder, daemon=True))
            threads += [threading.Thread(target=sample_worker, args=(int(sd),), daemon=True) for sd in seeds]
            threads.append(threading.Thread(target=put_batches, args=(assembled(),), daemon=True))
        for t in threads:
            t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
