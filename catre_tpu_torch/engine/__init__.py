"""Inference engine: the iterative refine loop."""
