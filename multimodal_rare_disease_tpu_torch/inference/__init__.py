"""Batch inference: packing and the predictor."""
