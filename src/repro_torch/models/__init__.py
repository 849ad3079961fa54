"""Model definitions and the architecture registry."""
