"""Batched rotation and point-cloud geometry (torch)."""
