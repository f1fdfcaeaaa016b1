"""Model modules; names follow the JAX package's flax trees."""
