"""caesar_mrcnn_tpu_torch — the PyTorch and CUDA port of caesar_mrcnn_tpu.

The JAX package ``caesar_mrcnn_tpu`` stays the reference; this package runs
its serving ``detect`` path (tiles -> Mask R-CNN -> per-tile detections and
masks) with PyTorch on an NVIDIA Hopper card. NMS and multilevel ROIAlign
are hand-written CUDA kernels (``csrc/``), built at first use; every other
stage is plain PyTorch. Host modules that import no JAX (``config``,
``utils.anchors``, ``utils.fits``, ``utils.zscale``, ``utils.tiles``,
``native``) are imported from the JAX package, not copied.

This package imports no jax, flax, cv2 or matplotlib.
"""

__version__ = "0.1.0"
