"""dbrx-132b [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4.

40L, d_model=6144, 48H (GQA kv=8), expert d_ff=10752, vocab=100352.
Full attention -> long_500k skipped.  ``router="matching"`` applies the
paper's technique to the top-4 assignment (4 demand units per token).
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, act="swiglu", attn="full",
    n_experts=16, top_k=4, router="matching", capacity_factor=1.25,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, act="swiglu", attn="full",
    n_experts=4, top_k=2, router="matching", capacity_factor=1.25,
    dtype="float32", remat=False,
)
