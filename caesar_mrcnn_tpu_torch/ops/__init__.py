"""Device ops: batched NMS and multilevel ROIAlign, each a CUDA kernel with
its plain PyTorch version beside it."""
