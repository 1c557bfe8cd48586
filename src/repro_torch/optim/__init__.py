"""Optimizers of the training state."""
