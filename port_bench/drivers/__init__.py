"""One driver a kind of traffic: build(cell, seed, device) -> a run."""
