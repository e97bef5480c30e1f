"""Data: dataset metadata and assets, PNG and RLE decoding, train-time depth
augmentation, and the test-phase loader (host decode, decoded caches, group
samplers, `CATRELoader`)."""
