"""Optimizers (Ranger so far)."""
