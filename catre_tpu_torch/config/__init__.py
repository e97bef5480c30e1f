"""Config loading (jax-free) and the model-config bridge."""
