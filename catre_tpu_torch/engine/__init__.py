"""Engines: the iterative refine loop and the training step."""
