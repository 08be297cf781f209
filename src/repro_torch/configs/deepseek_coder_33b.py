"""deepseek-coder-33b [arXiv:2401.14196; hf] — dense llama-arch.

62L, d_model=7168, 56H (GQA kv=8), d_ff=19200, vocab=32256.
Full attention -> long_500k skipped.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, act="swiglu", attn="full",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=512, act="swiglu", attn="full",
    dtype="float32", remat=False,
)
