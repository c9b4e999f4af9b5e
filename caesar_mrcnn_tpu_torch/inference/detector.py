"""Detection pipeline: mold -> forward on the device -> unmold (port of
``caesar_mrcnn_tpu/inference/detector.py``, serving half).

The entry points are the ones the host layer calls: :meth:`Detector.detect`
on host images, and the tiled fast path :meth:`Detector.dispatch_tiles` /
:meth:`Detector.collect` (or :meth:`Detector.detect_tiles`) on u8 tiles. On
a CUDA device, ``dispatch_tiles`` copies the tiles from pinned memory
asynchronously, enqueues the whole step, starts the device->host copies of
the results into pinned buffers and records an event; ``collect`` waits on
that event and unmolds. Nothing in between reads a value back to the host,
so a caller can keep several batches in flight.

With ``config.quant_mode="int8"`` the step runs the int8 graph
(``models/heads_int8.py``): the first batch of :meth:`Detector.detect` or
:meth:`Detector.dispatch_tiles` calibrates it (or :meth:`Detector.quantize`
does, on given images), and any change of the model's weights after that
(``load_state_dict``, ``restore_weights``, an edit in place) drops it, so
the next batch calibrates again.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import weights as W
from ..config import Config
from ..models.mask_rcnn import MaskRCNN, forward_inference
from ..models.meta import compose_image_meta
from ..utils import boxes as B
from ..utils import image as I
from ..utils.anchors import get_anchors


class Detector:
    """Model on one device, with the detect step and its host halves."""

    def __init__(self, config: Config, model: MaskRCNN, device):
        if config.num_devices != 1:
            raise ValueError("the port runs on one device (num_devices=1)")
        check_inference_config(config)
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        dev = self.device
        self._rpn_std = torch.tensor(config.rpn_bbox_std_dev, dtype=torch.float32, device=dev)
        self._bbox_std = torch.tensor(config.bbox_std_dev, dtype=torch.float32, device=dev)
        self._mean = torch.tensor(config.mean_pixel, dtype=torch.float32, device=dev)
        self._consts = {}  # (h, w, c) -> device anchors, tile metas
        self.qtree = None  # the int8 graph's numpy tree, once quantized
        self._stages = None  # the int8 graph (heads_int8.DetectStages)
        self._stages_version = None  # the weights' version it was quantized from

    def _constants(self, shape):
        """Device-resident anchors and full-frame tile metas per input shape."""
        key = tuple(int(v) for v in shape)
        if key not in self._consts:
            cfg = self.config
            h, w, _ = key
            meta = compose_image_meta(0, key, key, (0, 0, h, w), 1.0, np.zeros(cfg.num_classes))
            metas = np.tile(meta, (cfg.batch_size, 1))
            self._consts[key] = (
                torch.from_numpy(get_anchors(cfg, key)).to(self.device),
                torch.from_numpy(metas).to(self.device),
            )
        return self._consts[key]

    @torch.inference_mode()
    def _step(self, molded: torch.Tensor, metas: torch.Tensor, anchors: torch.Tensor, n_in: int):
        """The detect graph on a device batch; in int8 mode, calibrated
        first on its ``n_in`` real images when there is no int8 graph for
        the current weights."""
        if self.int8_graph() is None and self.config.quant_mode == "int8":
            self._quantize_molded(molded[:n_in], metas[:n_in], anchors)
        graph = self.model if self._stages is None else self._stages
        return forward_inference(graph, molded, metas, anchors, self._rpn_std, self._bbox_std)

    # ------------------------------------------------------- quantization
    def int8_graph(self):
        """The int8 graph (``heads_int8.DetectStages``) for the current
        weights, or None; one quantized from weights that have changed
        since is dropped."""
        if self._stages is not None and self._stages_version != self._weights_version():
            self._stages = self.qtree = None
        return self._stages

    def _weights_version(self) -> int:
        """Changes whenever a parameter or buffer of the model is written in
        place (``load_state_dict`` copies into them)."""
        return sum(t._version for t in itertools.chain(self.model.parameters(), self.model.buffers()))

    def quantize(self, calib_images: Sequence[np.ndarray]) -> None:
        """Post-training int8 quantization of the detect graph: frozen batch
        norm folded, per-tensor activation scales calibrated on
        ``calib_images`` (host images, molded as :meth:`detect` molds them;
        the folded f32 graph runs with TF32 switched off for the pass and
        restored after, ``backbone_int8.exact_f32``), weights quantized per
        output channel. The step then runs the int8 graph, until the
        weights change."""
        molded, metas, _ = self.mold_inputs(calib_images)
        anchors, _ = self._constants(molded.shape[1:])
        with torch.inference_mode():
            self._quantize_molded(torch.from_numpy(molded).to(self.device),
                                  torch.from_numpy(metas).to(self.device), anchors)

    def _quantize_molded(self, molded: torch.Tensor, metas: torch.Tensor, anchors: torch.Tensor) -> None:
        from ..models import heads_int8 as Q

        self.use_qtree(Q.build_detect_qtree(self.model, molded, metas, anchors))

    def use_qtree(self, qtree: Dict) -> None:
        """Run the int8 graph of ``qtree`` (a numpy quantized tree in the JAX
        package's layout: ``heads_int8.build_detect_qtree``'s, or one from
        another detector with the same weights)."""
        from ..models import heads_int8 as Q

        self._stages = Q.int8_stages(self.model, qtree)
        self.qtree = qtree
        self._stages_version = self._weights_version()

    # ----------------------------------------------------------- molding
    def mold_inputs(self, images: Sequence[np.ndarray]):
        """Resize + mean-subtract + pack meta."""
        cfg = self.config
        molded, metas, windows = [], [], []
        for image in images:
            m, window, scale, _pad, _crop = I.resize_image(
                image,
                min_dim=cfg.image_min_dim,
                min_scale=cfg.image_min_scale,
                max_dim=cfg.image_max_dim,
                mode=cfg.image_resize_mode,
            )
            molded.append(I.mold_image(m, cfg.mean_pixel))
            metas.append(
                compose_image_meta(0, image.shape, m.shape, window, scale, np.zeros(cfg.num_classes))
            )
            windows.append(window)
        return (
            np.stack(molded).astype(np.float32),
            np.stack(metas).astype(np.float32),
            np.stack(windows),
        )

    # ------------------------------------------------------------ unmold
    def unmold_detections(
        self, detections: np.ndarray, mrcnn_mask: np.ndarray,
        original_image_shape, image_shape, window,
    ):
        """One image's padded outputs -> pixel-space results."""
        zero_ix = np.where(detections[:, 4] == 0)[0]
        n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

        boxes = detections[:n, :4]
        class_ids = detections[:n, 4].astype(np.int32)
        scores = detections[:n, 5]
        masks = mrcnn_mask[:n]
        if masks.dtype == np.uint8:  # u8 mask wire
            masks = masks.astype(np.float32) / 255.0

        wy1, wx1, wy2, wx2 = B.norm_boxes(np.asarray(window), image_shape[:2])
        shift = np.array([wy1, wx1, wy1, wx1])
        scale = np.array([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
        boxes = B.denorm_boxes(np.divide(boxes - shift, scale), original_image_shape[:2])

        keep = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0
        boxes, class_ids, scores, masks = boxes[keep], class_ids[keep], scores[keep], masks[keep]
        # Pasting into one preallocated [H, W, n] frame: stacking n separate
        # full frames along the last axis cost ~1.2 ms per detection.
        full_masks = np.zeros(tuple(original_image_shape[:2]) + (len(boxes),), dtype=bool)
        for i in range(len(boxes)):
            I.paste_mask(masks[i], boxes[i], full_masks[..., i])
        return boxes, class_ids, scores, full_masks

    # ------------------------------------------------- tiled fast path
    def dispatch_tiles(self, tiles: np.ndarray):
        """Enqueue detection on a batch of pre-sized tiles.

        ``tiles``: [B, H, W] (grayscale, broadcast to the model's channels on
        the device) or [B, H, W, C], any dtype (u8 on the fast path);
        (H, W) must equal ``config.image_shape[:2]``. Returns a handle for
        :meth:`collect`.
        """
        cfg = self.config
        h, w, c = cfg.image_shape
        n_in, bs = tiles.shape[0], cfg.batch_size
        if not 0 < n_in <= bs:
            raise ValueError(f"dispatch_tiles got {n_in} tiles, batch_size={bs}")
        if tuple(tiles.shape[1:3]) != (h, w):
            raise ValueError(f"tiles {tiles.shape[1:3]} != network input {(h, w)}")
        if n_in < bs:
            tiles = np.concatenate([tiles, np.repeat(tiles[-1:], bs - n_in, axis=0)])
        anchors, metas = self._constants((h, w, c))
        cuda = self.device.type == "cuda"
        host = torch.from_numpy(np.ascontiguousarray(tiles))
        if cuda:
            host = host.pin_memory()
        raw = host.to(self.device, non_blocking=cuda)
        # premold on the device: cast, gray -> channels, mean subtraction
        x = raw.float()
        if x.dim() == 3:
            x = x[..., None].expand(-1, -1, -1, c)
        out = self._step(x - self._mean, metas, anchors, n_in)
        fetched = [self._to_host(t, cuda) for t in (out.detections, out.masks)]
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return fetched, event, n_in, (h, w, c)

    @staticmethod
    def _to_host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
        if not pinned:
            return t.cpu()
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        return dst

    def fetch(self, handle):
        """Wait for a dispatched batch: (detections, masks, n_in, shape)."""
        (detections, masks), event, n_in, shape = handle
        if event is not None:
            event.synchronize()
        return detections.numpy(), masks.numpy(), n_in, shape

    def unmold_fetched(self, fetched) -> List[Dict]:
        """Host unmold of a fetched batch (full-frame tile windows)."""
        detections, masks, n_in, shape = fetched
        window = (0, 0, shape[0], shape[1])
        results = []
        for i in range(n_in):
            rois, class_ids, scores, full_masks = self.unmold_detections(
                detections[i], masks[i], shape, shape, window
            )
            results.append({"rois": rois, "class_ids": class_ids, "scores": scores,
                            "masks": full_masks})
        return results

    def collect(self, handle) -> List[Dict]:
        """Fetch + unmold a :meth:`dispatch_tiles` batch."""
        return self.unmold_fetched(self.fetch(handle))

    def detect_tiles(self, tiles: np.ndarray) -> List[Dict]:
        """Synchronous tiled fast path (dispatch + collect)."""
        return self.collect(self.dispatch_tiles(tiles))

    # ------------------------------------------------------------ detect
    def detect(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """Detect on host images of any size; per-image dicts {rois,
        class_ids, scores, masks}."""
        cfg = self.config
        n_in, bs = len(images), cfg.batch_size
        if not 0 < n_in <= bs:
            raise ValueError(f"detect got {n_in} images, batch_size={bs}")
        molded, metas, windows = self.mold_inputs(images)
        if n_in < bs:  # pad the tail to the batch
            molded = np.concatenate([molded, np.repeat(molded[-1:], bs - n_in, axis=0)])
            metas = np.concatenate([metas, np.repeat(metas[-1:], bs - n_in, axis=0)])
        anchors, _ = self._constants(molded.shape[1:])
        out = self._step(
            torch.from_numpy(molded).to(self.device),
            torch.from_numpy(metas).to(self.device),
            anchors,
            n_in,
        )
        detections = out.detections.cpu().numpy()
        masks = out.masks.cpu().numpy()
        results = []
        for i in range(n_in):
            rois, class_ids, scores, full_masks = self.unmold_detections(
                detections[i], masks[i], images[i].shape, molded[i].shape, windows[i]
            )
            results.append({"rois": rois, "class_ids": class_ids, "scores": scores,
                            "masks": full_masks})
        return results


def check_inference_config(config: Config) -> None:
    """Refuse the inference options the port does not run: an unknown
    ``quant_mode`` (it takes ``"none"`` and ``"int8"``) and a
    ``roi_gather_dtype`` other than ``"none"`` (the JAX package's reduced
    precision ROIAlign gather is on the ROADMAP's "Not to port" list)."""
    if config.quant_mode not in ("none", "int8"):
        raise ValueError(f"quant_mode={config.quant_mode!r}: the port takes 'none' or 'int8'")
    if config.roi_gather_dtype != "none":
        raise NotImplementedError(
            f"roi_gather_dtype={config.roi_gather_dtype!r}: the reduced-precision ROIAlign gather is "
            "'Not to port' (ROADMAP); the port takes only 'none'"
        )


def build_detector(
    config: Config,
    weights_path: Optional[str] = None,
    exclude: Optional[Sequence[str]] = None,
    seed: int = 0,
    device="cuda",
    weights: Optional[dict] = None,
) -> Detector:
    """Model + weights on ``device``: the card unless the caller asks for
    another device (``device="cpu"`` runs the kernels' plain versions).

    The weights start random, made on the CPU from ``seed`` by flax's
    default scheme (so the same seed gives the same weights on every
    device), or from ``weights``, a numpy flax variable tree (converted by
    ``weights.flax_to_state_dict``). ``weights_path`` (a ``.pt`` checkpoint
    or a Keras ``.h5``) is then restored over them by name, skipping the
    flax paths that match an ``exclude`` regex
    (``train.checkpoints.restore_weights``).
    """
    from ..train.checkpoints import restore_weights

    if config.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={config.num_devices}: the port detects on one device; data parallelism "
            "is ROADMAP item A13"
        )
    model = MaskRCNN(config)
    if weights is not None:
        model.load_state_dict(W.flax_to_state_dict(weights))
    else:
        W.init_weights(model, torch.Generator().manual_seed(seed))
    if weights_path:
        restore_weights(model, weights_path, exclude=exclude)
    return Detector(config, model, device)
