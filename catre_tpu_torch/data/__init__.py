"""Train-time data augmentation (the loader itself is not ported yet)."""
