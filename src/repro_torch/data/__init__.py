"""Synthetic data: the learnable token stream the trainer feeds on."""
