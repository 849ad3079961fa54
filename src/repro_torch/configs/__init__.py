"""Architecture configs (copies of the JAX package's, in the port's own
config types)."""
