"""Detection pipeline: mold -> forward on the device -> unmold (port of
``caesar_mrcnn_tpu/inference/detector.py``, serving half).

The entry points are the ones the host layer calls: :meth:`Detector.detect`
on host images, and the tiled fast path :meth:`Detector.dispatch_tiles` /
:meth:`Detector.collect` (or :meth:`Detector.detect_tiles`) on u8 tiles. On
a CUDA device, ``dispatch_tiles`` copies the tiles from pinned memory
asynchronously, enqueues the whole step, starts the device->host copies of
the results into pinned buffers, launches the paste of every tile's masks
into its full frame in pinned host memory (``ops/paste.py``) and records
an event; ``collect`` waits on that event and unmolds, which then only
views the frames. Nothing in between reads a value back to the host, so a
caller can keep several batches in flight.

With ``config.quant_mode="int8"`` the step runs the int8 graph
(``models/heads_int8.py``): the first batch of :meth:`Detector.detect` or
:meth:`Detector.dispatch_tiles` calibrates it (or :meth:`Detector.quantize`
does, on given images), and any change of the model's weights after that
(``load_state_dict``, ``restore_weights``, an edit in place) drops it, so
the next batch calibrates again.

Over several devices (the JAX package's ``Detector(mesh=...)``) the
detector holds one model replica per device (``parallel.mesh.local_devices``;
``config.batch_size`` is the global batch, ``images_per_device`` rows per
device): ``dispatch_tiles`` and ``detect`` cut the batch into contiguous
per-device slices and enqueue each replica's step on its own device, with
nothing read back in between; ``collect`` joins the slices. The replicas
follow the first device's model whenever its weights change, and the int8
graph is calibrated once, on the first device over the global batch as
the one-device detector calibrates, each replica running the same
quantized tree.

On a CUDA device the float graph's feature stage (backbone and FPN) runs
as one CUDA graph a device (``inference/graphed.py``), captured in the
first step; the int8 graph, and any graph on the CPU, run eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from .. import weights as W
from ..config import Config
from ..models.mask_rcnn import MaskRCNN, forward_inference
from ..models.meta import compose_image_meta
from ..ops import paste as P
from ..parallel.mesh import local_devices, shard_rows
from ..utils import boxes as B
from ..utils import image as I
from ..utils.anchors import get_anchors
from . import graphed as G

log = logging.getLogger(__name__)


class Detector:
    """Model on one device, or one replica per device of a list
    (``config.num_devices`` of them), with the detect step and its host
    halves."""

    def __init__(self, config: Config, model: MaskRCNN, device):
        check_inference_config(config)
        devices = [torch.device(d) for d in (device if isinstance(device, (list, tuple)) else [device])]
        if len(devices) != config.num_devices:
            raise ValueError(f"{len(devices)} devices for config.num_devices={config.num_devices}")
        self.config = config
        self.devices = devices
        self.device = devices[0]
        self.model = model.to(self.device).eval()
        # the replicas of the other devices, loaded from self.model whenever its weights change
        self._models = [self.model] + [copy.deepcopy(self.model).to(d) for d in devices[1:]]
        self._models_version = self._weights_version()
        self._consts_of = [self._device_constants(d) for d in devices]
        self._rpn_std, self._bbox_std, self._mean = self._consts_of[0]
        self._consts = {}  # (device index, (h, w, c)) -> device anchors, tile metas
        self.qtree = None  # the int8 graph's numpy tree, once quantized
        self._stages = None  # the int8 graph (heads_int8.DetectStages)
        self._replica_stages = None  # the other devices' int8 graphs
        self._stages_version = None  # the weights' version it was quantized from
        self._graphed = {}  # device index -> its model's GraphedFeatures
        self._batch_ids = itertools.count()  # the id of each batch, carried by its handle and its spans
        self._pasting = collections.deque()  # (events, frames) of batches the device may still write

    def _device_constants(self, dev):
        cfg = self.config
        return tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                     for v in (cfg.rpn_bbox_std_dev, cfg.bbox_std_dev, cfg.mean_pixel))

    def _constants(self, shape, index: int = 0):
        """Device ``index``'s anchors and full-frame tile metas (one per row
        of its slice of the batch) per input shape."""
        key = (index, tuple(int(v) for v in shape))
        if key not in self._consts:
            cfg = self.config
            h, w, _ = key[1]
            meta = compose_image_meta(0, key[1], key[1], (0, 0, h, w), 1.0, np.zeros(cfg.num_classes))
            metas = np.tile(meta, (cfg.batch_size // len(self.devices), 1))
            dev = self.devices[index]
            self._consts[key] = (
                torch.from_numpy(get_anchors(cfg, key[1])).to(dev),
                torch.from_numpy(metas).to(dev),
            )
        return self._consts[key]

    def _replicas(self) -> List[MaskRCNN]:
        """The model of every device, the replicas loaded with the first
        device's weights when these changed."""
        version = self._weights_version()
        if version != self._models_version:
            state = self.model.state_dict()
            for m in self._models[1:]:
                m.load_state_dict(state)
            self._models_version = version
            self._replica_stages = None
        return self._models

    def _graph(self, index: int):
        """Device ``index``'s detect graph: its model, that model with its
        features replayed as a CUDA graph (``graphed.engages``), or its
        int8 graph."""
        models = self._replicas()
        stages = self.int8_graph()
        if G.engages(self.devices[index], stages):
            if index not in self._graphed:
                self._graphed[index] = G.GraphedFeatures(models[index])
            return self._graphed[index]
        if stages is None:
            return models[index]
        if index == 0:
            return self._stages
        if self._replica_stages is None:
            from ..models import heads_int8 as Q

            self._replica_stages = [Q.int8_stages(m, self.qtree) for m in models[1:]]
        return self._replica_stages[index - 1]

    @torch.inference_mode()
    def _step(self, molded: torch.Tensor, metas: torch.Tensor, anchors: torch.Tensor, n_in: int,
              index: int = 0):
        """The detect graph of device ``index`` on its batch; in int8 mode,
        calibrated first on its ``n_in`` real images when there is no int8
        graph for the current weights (over several devices the caller
        calibrates on the global batch first)."""
        if self.int8_graph() is None and self.config.quant_mode == "int8":
            self._quantize_molded(molded[:n_in], metas[:n_in], anchors)
        return forward_inference(self._graph(index), molded, metas, anchors, *self._consts_of[index][:2])

    # ------------------------------------------------------- quantization
    def int8_graph(self):
        """The int8 graph (``heads_int8.DetectStages``) for the current
        weights, or None; one quantized from weights that have changed
        since is dropped."""
        if self._stages is not None and self._stages_version != self._weights_version():
            self._stages = self.qtree = self._replica_stages = None
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
        """Fold the detect graph's batch norms, calibrate it on ``molded``,
        quantize it and run it: the span ``detect.int8.calibrate``, with
        ``.observe`` (the folded f32 pass that sees every site's input) and
        ``.quantize`` (the tree quantized and put on the device), and the
        counter ``detect.int8.sites`` (the tree's sites)."""
        from ..models import heads_int8 as Q

        with telemetry.span("detect.int8.calibrate"):
            folded = Q.fold_detect(W.state_dict_to_flax(self.model.state_dict()), self.model.config)
            with telemetry.span("detect.int8.calibrate.observe"):
                scales = Q.calibrate_detect(self.model, folded, molded, metas, anchors)
            with telemetry.span("detect.int8.calibrate.quantize"):
                qtree = Q.quantize_detect(folded, scales)
                self.use_qtree(qtree)
            telemetry.count("detect.int8.sites", len(qtree))

    def use_qtree(self, qtree: Dict) -> None:
        """Run the int8 graph of ``qtree`` (a numpy quantized tree in the JAX
        package's layout: ``heads_int8.quantize_detect``'s, or one from
        another detector with the same weights)."""
        from ..models import heads_int8 as Q

        self._stages = Q.int8_stages(self.model, qtree)
        self._replica_stages = None
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
        if telemetry.active():
            resize_ns = write_ns = 0
            for i in range(len(boxes)):
                r, w = I.paste_mask_timed(masks[i], boxes[i], full_masks[..., i])
                resize_ns, write_ns = resize_ns + r, write_ns + w
            telemetry.count("detect.unmold.resize_ns", resize_ns)
            telemetry.count("detect.unmold.write_ns", write_ns)
        else:
            for i in range(len(boxes)):
                I.paste_mask(masks[i], boxes[i], full_masks[..., i])
        return boxes, class_ids, scores, full_masks

    # ------------------------------------------------- tiled fast path
    def dispatch_tiles(self, tiles: np.ndarray):
        """Enqueue detection on a batch of pre-sized tiles.

        ``tiles``: [B, H, W] (grayscale, broadcast to the model's channels on
        the device) or [B, H, W, C], any dtype (u8 on the fast path);
        (H, W) must equal ``config.image_shape[:2]``. Returns a handle for
        :meth:`collect`: ``(host outputs, events, n_in, shape, batch id,
        frames)``, its events (``handle[1]``) recorded after the step's
        copies to the host and, with the u8 mask wire, the paste of each
        real tile's masks into its frame (``frames``; else None).
        """
        cfg = self.config
        h, w, c = cfg.image_shape
        n_in, bs = tiles.shape[0], cfg.batch_size
        if not 0 < n_in <= bs:
            raise ValueError(f"dispatch_tiles got {n_in} tiles, batch_size={bs}")
        if tuple(tiles.shape[1:3]) != (h, w):
            raise ValueError(f"tiles {tiles.shape[1:3]} != network input {(h, w)}")
        batch = next(self._batch_ids)
        cuda = self.device.type == "cuda"
        with telemetry.span("detect.stage_in", batch=batch):
            if n_in < bs:
                tiles = np.concatenate([tiles, np.repeat(tiles[-1:], bs - n_in, axis=0)])
            host = torch.from_numpy(np.ascontiguousarray(tiles))
            if cuda:
                host = host.pin_memory()

        def inputs(rows, index):
            # premold on the device: cast, gray -> channels, mean subtraction
            x = host[rows].to(self.devices[index], non_blocking=cuda).float()
            if x.dim() == 3:
                x = x[..., None].expand(-1, -1, -1, c)
            metas = self._constants((h, w, c), index)[1]
            return x - self._consts_of[index][2], metas[:1].expand(x.shape[0], -1)

        return self._run_slices(inputs, n_in, (h, w, c), batch, cfg.mask_wire_dtype == "uint8")

    def _run_slices(self, inputs, n_in: int, shape, batch: int, paste: bool = False):
        """Each device's step on its slice of the batch (``inputs(rows,
        index)`` gives its molded images and metas, on the device), its
        results' copies to the host started and, with ``paste``, its real
        tiles' masks pasted into new frames (full-frame tile windows);
        returns the handle of :meth:`fetch`. Over several devices an int8
        graph is calibrated first, on the first device over the global
        batch's real images."""
        n = len(self.devices)
        cuda = self.device.type == "cuda"
        if n > 1 and self.config.quant_mode == "int8" and self.int8_graph() is None:
            with torch.inference_mode():
                self._quantize_molded(*inputs(slice(0, n_in), 0), self._constants(shape)[0])
        self._release_pasted()
        fetched, events, frames = [], [], [] if paste else None
        for i, dev in enumerate(self.devices):
            rows = shard_rows(self.config.batch_size, n, i)
            real = max(0, min(n_in, rows.stop) - rows.start)
            anchors = self._constants(shape, i)[0]
            with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
                with telemetry.span("detect.stage_in", batch=batch):
                    molded, metas = inputs(rows, i)
                with telemetry.span("detect.step", batch=batch):
                    out = self._step(molded, metas, anchors, real, i)
                    fetched.append([self._to_host(t, cuda) for t in (out.detections, out.masks)])
                    if paste:
                        frames += self._paste(out.detections[:real], out.masks[:real], shape[:2], cuda)
                    if cuda:
                        events.append(torch.cuda.Event())
                        events[-1].record()
        if paste:
            self._pasting.append((events, frames))
        return fetched, events, n_in, shape, batch, frames

    @staticmethod
    def _to_host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
        if not pinned:
            return t.cpu()
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        return dst

    @staticmethod
    def _paste(detections: torch.Tensor, masks: torch.Tensor, hw, pinned: bool) -> List[torch.Tensor]:
        """New frames for the tiles of ``detections``, their masks' paste
        into them launched (``ops/paste.py``): on a CUDA device, pinned
        host blocks that the kernel writes over PCIe and that PyTorch's
        host allocator hands out again once the caller drops them."""
        size = hw[0] * hw[1] * detections.shape[1]
        frames = [torch.empty(size, dtype=torch.bool, pin_memory=pinned) for _ in range(detections.shape[0])]
        P.paste_masks(detections, masks, frames, hw)
        return frames

    def _release_pasted(self) -> None:
        """Let go of the frames of the batches whose events have completed.
        Until then the detector holds them, so that a handle dropped
        unfetched cannot free a frame the device still writes."""
        while self._pasting and all(e.query() for e in self._pasting[0][0]):
            self._pasting.popleft()

    def fetch(self, handle):
        """Wait for a dispatched batch: (detections, masks, n_in, shape,
        batch id, frames), ``frames`` the real tiles' pasted frames in
        order over the devices (None where the batch was not pasted)."""
        fetched, events, n_in, shape, batch, frames = handle
        with telemetry.span("detect.fetch", batch=batch):
            for event in events:
                event.synchronize()
            self._release_pasted()
            detections, masks = (np.concatenate([f[j].numpy() for f in fetched]) if len(fetched) > 1
                                 else fetched[0][j].numpy() for j in (0, 1))
        return detections, masks, n_in, shape, batch, frames

    def unmold_fetched(self, fetched) -> List[Dict]:
        """Unmold of a fetched batch (full-frame tile windows): each pasted
        tile's masks a ``[H, W, n]`` view of its frame; the f32 mask wire's
        (``frames`` None) by the host unmold."""
        detections, masks, n_in, shape, batch, frames = fetched
        window = (0, 0, shape[0], shape[1])
        results = []
        with telemetry.span("detect.unmold", batch=batch):
            if frames is None:
                for i in range(n_in):
                    rois, class_ids, scores, full_masks = self.unmold_detections(
                        detections[i], masks[i], shape, shape, window
                    )
                    results.append({"rois": rois, "class_ids": class_ids, "scores": scores,
                                    "masks": full_masks})
            else:
                h, w = shape[:2]
                for i in range(n_in):
                    rows, rois = P.kept_boxes(detections[i], (h, w))
                    k = len(rows)
                    results.append({"rois": rois, "class_ids": detections[i, rows, 4].astype(np.int32),
                                    "scores": detections[i, rows, 5],
                                    "masks": frames[i][: h * w * k].view(h, w, k).numpy()})
                telemetry.count("detect.unmold.device_pasted", sum(len(r["scores"]) for r in results))
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

        def inputs(rows, index):
            dev = self.devices[index]
            return torch.from_numpy(molded[rows]).to(dev), torch.from_numpy(metas[rows]).to(dev)

        handle = self._run_slices(inputs, n_in, molded.shape[1:], next(self._batch_ids))
        detections, masks, _, _, batch, _ = self.fetch(handle)
        results = []
        with telemetry.span("detect.unmold", batch=batch):
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
    With ``config.num_devices > 1``, one replica on each of the first
    ``num_devices`` devices of ``device``'s kind
    (``parallel.mesh.local_devices``); with fewer there, ``num_devices``
    shrinks to those (and the global batch with it), with a warning.

    The weights start random, made on the CPU from ``seed`` by flax's
    default scheme (so the same seed gives the same weights on every
    device), or from ``weights``, a numpy flax variable tree (converted by
    ``weights.flax_to_state_dict``). ``weights_path`` (a ``.pt`` checkpoint
    or a Keras ``.h5``) is then restored over them by name, skipping the
    flax paths that match an ``exclude`` regex
    (``train.checkpoints.restore_weights``).
    """
    from ..train.checkpoints import restore_weights

    devices = [torch.device(device)]
    if config.num_devices > 1:
        devices = local_devices(torch.device(device).type, config.num_devices)
        if len(devices) < config.num_devices:
            # Shrink to the devices that exist instead of running the full
            # global batch (images_per_device * num_devices) on fewer cards
            avail = max(len(devices), 1)
            log.warning(
                "config.num_devices=%d but only %d local devices: shrinking to num_devices=%d (batch %d -> %d)",
                config.num_devices, len(devices), avail, config.batch_size, config.images_per_device * avail,
            )
            config = config.replace(num_devices=avail)
            devices = devices or [torch.device(device)]
    model = MaskRCNN(config)
    if weights is not None:
        model.load_state_dict(W.flax_to_state_dict(weights))
    else:
        W.init_weights(model, torch.Generator().manual_seed(seed))
    if weights_path:
        restore_weights(model, weights_path, exclude=exclude)
    return Detector(config, model, devices if len(devices) > 1 else devices[0])
