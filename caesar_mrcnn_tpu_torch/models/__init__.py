"""Mask R-CNN modules (backbone, FPN, RPN, heads), the functions of the
inference graph (proposals, refinement, forward_inference) and of the
training graph (targets, losses, forward_train)."""
