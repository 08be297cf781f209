"""repro_torch: the paper's bipartite-matching system in PyTorch, with its
frontier sweep in a hand-written CUDA kernel for Hopper (sm_90a).

It imports neither JAX nor the JAX package ``repro``, which stays beside it
as the reference.
"""
__version__ = "0.1.0"
