"""Config loading (jax-free) and the bridge to the model, loss and noise configs."""
