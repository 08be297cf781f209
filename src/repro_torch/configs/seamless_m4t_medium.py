"""seamless-m4t-medium [arXiv:2308.11596; hf] — enc-dec, multimodal (audio).

12L decoder + 12L encoder, d_model=1024, 16H (MHA kv=16), d_ff=4096,
vocab=256206.  The audio frontend is a STUB per spec: input_specs provides
precomputed frame embeddings (B, S_enc, d_model).
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, act="gelu", attn="full",
    enc_layers=12, frontend="audio", frontend_len=1024,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, act="gelu", attn="full",
    enc_layers=2, frontend="audio", frontend_len=16,
    dtype="float32", remat=False,
)
