"""Host data layer: the training pipeline, the dataset classes and the
augmentations (copies of the JAX package's ``data.dataset`` and
``data.augment``)."""
