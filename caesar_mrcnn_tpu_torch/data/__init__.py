"""Host data layer: the training pipeline. The dataset classes and the
augmentations are the JAX package's, imported (they import no jax)."""
