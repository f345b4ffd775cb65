"""Training data: the deterministic synthetic token pipeline."""
