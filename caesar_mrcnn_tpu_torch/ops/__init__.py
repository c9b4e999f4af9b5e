"""Device ops: batched NMS, multilevel ROIAlign and its gradient, the
mask-target crop_and_resize, the int8 quantizer and the int8 convolution,
the tiles' mask paste and the frozen batch norms' fold into their
convolutions, each a CUDA kernel with its plain PyTorch version beside it,
and the folded convolution's fused epilogue (cuDNN's), reached through one
operator namespace (``library.py``: ``torch.ops.caesar``)."""

from . import library  # noqa: F401  (registers the caesar operators)
