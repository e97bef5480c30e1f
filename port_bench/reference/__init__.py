"""The plain reference of the benchmark: CATRE's refiner, training step and
the judge of a sampled cloud in plain PyTorch and float32 or float64. It
imports nothing of the program and takes nothing the program has made."""
