"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``), each
with its plain PyTorch version beside it."""
