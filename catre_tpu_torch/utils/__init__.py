"""Parameter conversion from the JAX package (`convert`), checkpoints in the
reference layout and the port's own (`checkpoint`), a training run's metric
writers (`events`) and profiler (`profiler`), debug drawing (`vis`)."""
