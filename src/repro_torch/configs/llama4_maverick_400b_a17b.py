"""llama4-maverick-400b-a17b [hf:meta-llama] — MoE 128e top-1, early fusion.

48L, d_model=5120, 40H (GQA kv=8), expert d_ff=8192, vocab=202048,
128 experts top-1 + one always-on shared expert (llama4 signature).
Attention is chunked-local (8192 chunks, iRoPE-style) -> sub-quadratic,
so the long_500k cell runs.

MoE routing is where the paper's technique lands: ``router="matching"``
assigns tokens to experts with the maximum-cardinality matching router
(repro_torch/moe/matching_router.py) instead of greedy capacity truncation.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, act="swiglu", attn="chunked", window=8192,
    n_experts=128, top_k=1, router="matching", capacity_factor=1.25,
    moe_shared_expert=True, fsdp=True,
)

SMOKE = ModelConfig(
    name="llama4-maverick-400b-a17b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, act="swiglu", attn="chunked", window=32,
    n_experts=4, top_k=1, router="matching", capacity_factor=1.25,
    moe_shared_expert=True, dtype="float32", remat=False,
)
