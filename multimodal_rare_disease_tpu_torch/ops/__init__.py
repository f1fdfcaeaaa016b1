"""Device-side preprocessing."""
