"""Checkpoints: packed serving export and load."""
