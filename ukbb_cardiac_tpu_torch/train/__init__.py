"""FCN training: steps, batch prefetching, the device slice pool and the
SA/LA trainer."""
