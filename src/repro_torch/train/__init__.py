"""Training: per-family losses and the train step."""
