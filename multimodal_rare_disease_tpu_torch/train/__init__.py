"""Host data pipeline of the torch package (the training loop itself is
not ported yet)."""
