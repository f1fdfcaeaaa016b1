"""Host-side data code of the torch package (tokenizer, clinical text,
image decode): its own copies of the JAX package's jax-free modules."""
