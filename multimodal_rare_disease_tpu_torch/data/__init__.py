"""Host-side data code of the torch package (tokenizer, clinical text,
the image corpus, the synthetic corpus): its own copies of the JAX
package's jax-free modules."""
