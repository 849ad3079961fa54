"""NN building blocks: norms, RoPE, attention, MLP."""
