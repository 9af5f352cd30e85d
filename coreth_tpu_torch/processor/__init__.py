"""Transaction-processing rules the replay slices read."""
