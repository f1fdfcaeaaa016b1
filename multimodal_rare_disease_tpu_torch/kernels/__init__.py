"""Hand-written Hopper kernels and their build (csrc/ → build/kernels/)."""
