"""Data: train-time augmentation and the loader's device half (the group
samplers); the host half (decode, caches, `CATRELoader`) is not ported yet."""
