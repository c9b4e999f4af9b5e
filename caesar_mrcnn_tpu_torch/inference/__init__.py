"""Detector: mold -> forward on the device -> unmold."""
