"""Parameter conversion from the JAX package (`convert`) and checkpoints: the
reference layout and the port's own (`checkpoint`)."""
