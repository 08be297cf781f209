"""zamba2-7b [arXiv:2411.15242] — hybrid Mamba2 + shared attention blocks.

81L mamba2 backbone, d_model=3584, shared attn block 32H (kv=32),
d_ff=14336 (shared block MLP), vocab=32000, ssm_state=64.
The shared transformer block (one set of weights) is applied every 14th
mamba block (~6 applications), approximating Zamba2's periodic shared block.
For the long_500k cell the shared block runs with a 4096 sliding window
(Zamba2's shared block is periodic; windowing it keeps the cell
sub-quadratic — noted in DESIGN.md).
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, act="swiglu", attn="swa", window=4096,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, shared_every=14,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, act="swiglu", attn="swa", window=32,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, shared_every=2,
    dtype="float32", remat=False,
)
