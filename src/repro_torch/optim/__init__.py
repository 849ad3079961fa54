"""Optimizers: AdamW with its schedule and global-norm clipping."""
