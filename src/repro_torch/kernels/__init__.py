"""Hand-written Hopper kernels (``../csrc``), their plain PyTorch versions,
and the quantized-GEMM dispatch layer."""
