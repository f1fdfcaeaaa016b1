"""Checkpoints and the host RNG streams."""
