"""Command-line tools of the port: probes and profiles that need a CUDA card, and
`convert_checkpoint`, which runs anywhere."""
