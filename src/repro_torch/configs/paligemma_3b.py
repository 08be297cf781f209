"""paligemma-3b [arXiv:2407.07726; hf] — VLM: SigLIP frontend + gemma LM.

18L, d_model=2048, 8H (GQA kv=1, head_dim 256), d_ff=16384 (GeGLU),
vocab=257216.  The SigLIP vision tower is a STUB per spec: input_specs
provides 256 precomputed patch embeddings; the backbone applies PaliGemma's
prefix-LM mask (bidirectional over image+prefix, causal over suffix).
Full attention -> long_500k skipped.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, act="geglu", attn="full",
    frontend="vision", frontend_len=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, act="geglu", attn="full",
    frontend="vision", frontend_len=8, tie_embeddings=True,
    dtype="float32", remat=False,
)
