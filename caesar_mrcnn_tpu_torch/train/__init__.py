"""Training: optimizer, train step, loop and checkpoints."""
