"""Mask R-CNN modules (backbone, FPN, RPN, heads) and the functions of the
inference graph (proposals, refinement, forward_inference)."""
