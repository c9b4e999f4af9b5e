"""Device ops: batched NMS, multilevel ROIAlign and its gradient, and the
mask-target crop_and_resize, each a CUDA kernel with its plain PyTorch
version beside it."""
