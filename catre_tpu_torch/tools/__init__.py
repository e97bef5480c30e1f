"""Command-line tools of the port that need a CUDA card."""
