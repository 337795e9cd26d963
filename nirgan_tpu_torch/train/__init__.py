"""Training: the train state, checkpoints and the single-device loop."""
