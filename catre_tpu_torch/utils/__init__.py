"""Parameter conversion from the JAX package."""
