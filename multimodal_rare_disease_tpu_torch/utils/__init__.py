"""Checkpoint helpers."""
