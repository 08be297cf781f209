"""mamba2-2.7b [arXiv:2405.21060] — attention-free SSM (SSD).

64L, d_model=2560, d_ff=0 (no FFN: mamba blocks only), vocab=50280,
ssm_state=128, expand=2, headdim=64 (80 heads).  O(1)-state decode ->
runs the long_500k cell natively.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, attn="full",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=512, attn="full",
    ssm_state=16, ssm_expand=2, ssm_headdim=16, tie_embeddings=True,
    dtype="float32", remat=False,
)
