"""The float detect graph's feature stage (backbone and FPN) replayed as one
CUDA graph a device and input shape.

Launching ResNet-101 and its FPN, some 600 small operators a batch, took
the host about twice the device's time for them (15 ms against 8.3 ms at
batch 8, 512^2, bf16, on an H100), and the tiled detector waited on it.
:class:`GraphedFeatures` stands in for a ``MaskRCNN`` in
``models/mask_rcnn.py::forward_inference``: its ``features`` copies the
molded batch into the graph's static input, replays the graph and returns
the graph's static pyramid (the capture of ``MaskRCNN.pyramid`` on the
cast batch); its ``config``, ``rpn``, ``classifier`` and ``mask`` are the
model's own, so the later stages run eagerly and every tensor
``forward_inference`` returns is made fresh for its batch. A replay
launches the kernels the eager stage launches, on the same inputs and in
the same order, so the pyramid equals the eager one bit for bit. The
per-call casts of the f32 weights (``models/layers.py``) are inside the
graph: a replay reads the live parameters.

Each device's model has its own ``GraphedFeatures``, captured on a stream
of that device. :func:`engages` is the rule
``inference/detector.py::Detector`` applies to each device. The graph
holds the parameters' storage, not their values: ``load_state_dict``
copies into that storage, so a replay after it computes with the new
weights. Counters (``telemetry``):
``detect.features.graph_captures`` (a graph captured) and
``detect.features.graph_replays`` (a batch's features replayed).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .. import telemetry
from ..models.mask_rcnn import MaskRCNN


def engages(device: torch.device, int8_graph) -> bool:
    """Whether a detector's features run as a CUDA graph on ``device``:
    the float graph (``int8_graph``, the detector's int8 graph, is None)
    on a CUDA device."""
    return int8_graph is None and device.type == "cuda"


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    images: torch.Tensor  # static input: the batch NCHW channels_last in the compute dtype
    pyramid: Tuple[torch.Tensor, ...]  # static outputs: P2..P6


class GraphedFeatures:
    """A ``MaskRCNN`` for ``forward_inference`` whose ``features`` replays
    a CUDA graph, captured on its first call for each shape of the molded
    batch."""

    def __init__(self, model: MaskRCNN):
        self.model = model
        self.config = model.config
        self.rpn, self.classifier, self.mask = model.rpn, model.classifier, model.mask
        self._graphs: Dict[tuple, _Captured] = {}

    def features(self, images: torch.Tensor):
        """images NHWC [B, H, W, C] -> (P2, ..., P6), the graph's static
        outputs, overwritten by the next replay."""
        x = images.permute(0, 3, 1, 2)
        key = tuple(images.shape)
        if key not in self._graphs:
            self._graphs[key] = self._capture(x.shape, x.device)
        captured = self._graphs[key]
        captured.images.copy_(x)  # the eager stage's cast to the compute dtype, channels_last
        # Every replay writes the same pyramid. With batches in flight, the
        # previous batch's RPN and ROIAligns were enqueued on this stream
        # before this replay, so stream order keeps it from overwriting the
        # pyramid under them.
        captured.graph.replay()
        telemetry.count("detect.features.graph_replays")
        return captured.pyramid

    def _capture(self, shape, device: torch.device) -> _Captured:
        images = torch.empty(shape, dtype=self.model.dtype, device=device, memory_format=torch.channels_last).zero_()
        # One eager pass first, so that cuDNN picks and sets up its
        # algorithms outside the capture, on a side stream of the model's
        # device; the capture goes on that stream too. (torch.cuda.graph's
        # default stream belongs to the device current at its first use.)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.model.pyramid(images)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread (SFinder.run_tiled's tile reader) may
        # pin host memory while this one captures
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            pyramid = self.model.pyramid(images)
        telemetry.count("detect.features.graph_captures")
        return _Captured(graph, images, pyramid)
