"""caesar_mrcnn_tpu_torch — the PyTorch and CUDA port of caesar_mrcnn_tpu.

The JAX package ``caesar_mrcnn_tpu`` stays the reference; this package runs
its serving ``detect`` path (tiles -> Mask R-CNN -> per-tile detections and
masks), the host layer on it (``analysis``: ``SFinder`` catalogs and DS9
regions, ``ModelTester`` evaluation) and its training path
(``TrainingPipeline`` -> ``forward_train`` -> losses -> backward ->
optimizer) with PyTorch on an NVIDIA Hopper card, exports the detect
graph as a ``torch.export`` artifact for serving (``inference/export.py``),
and classifies the sources of a catalog (``analysis/classifier.py``,
``cli/sclassifier.py``).
NMS, multilevel ROIAlign and its gradient, the mask-target
crop_and_resize, the int8 quantizer and the int8 convolution are
hand-written CUDA kernels (``csrc/``), built at first use and reached as
operators of the ``caesar`` namespace (``ops/library.py``); every other
stage is plain PyTorch.

The host modules it needs keep the JAX package's module paths as copies of
their own (``config``, ``data.dataset``, ``data.augment``,
``data.synthetic``, ``utils.anchors``, ``utils.fits``, ``utils.zscale``, ``utils.tiles``,
``utils.graph``, ``utils.stats``, ``models.debug_rois``, ``evalmetrics``,
``analysis`` and the C++ host library ``native``), so this package imports
nothing of ``caesar_mrcnn_tpu``, and no jax, flax, optax, orbax, cv2,
networkx or matplotlib.
"""

import logging

__version__ = "0.3.0"

# The package logger (the JAX package's, under this package's name).
logger = logging.getLogger("caesar_mrcnn_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s - %(message)s", "%Y-%m-%d %H:%M:%S")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
