"""caesar_mrcnn_tpu_torch — the PyTorch and CUDA port of caesar_mrcnn_tpu.

The JAX package ``caesar_mrcnn_tpu`` stays the reference; this package runs
its serving ``detect`` path (tiles -> Mask R-CNN -> per-tile detections and
masks) and its training path (``TrainingPipeline`` -> ``forward_train`` ->
losses -> backward -> optimizer) with PyTorch on an NVIDIA Hopper card.
NMS, multilevel ROIAlign and its gradient, and the mask-target
crop_and_resize are hand-written CUDA kernels (``csrc/``), built at first
use; every other stage is plain PyTorch. Host modules that import no JAX
(``config``, ``data.dataset``, ``data.augment``, ``utils.anchors``,
``utils.fits``, ``utils.zscale``, ``utils.tiles``, ``native``) are imported
from the JAX package, not copied; ``caesar_mrcnn_tpu_torch.host`` re-exports
the ones a caller of the port needs, so that the caller imports only this
package.

This package imports no jax, flax, optax, orbax, cv2 or matplotlib.
"""

__version__ = "0.2.0"
