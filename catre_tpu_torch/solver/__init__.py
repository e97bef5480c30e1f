"""Optimizers (the registry of `solver/build.py`) and learning-rate schedules."""
