"""Hand-written Hopper kernels and their plain PyTorch versions — the
counterpart of ``repro.kernels``."""
