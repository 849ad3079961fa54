"""Numerics core of the port: bit packing, quantizers, policy, layers,
converter."""
