"""granite-20b [arXiv:2405.04324; hf] — dense code model, MQA (kv=1).

52L, d_model=6144, 48H (GQA kv=1), d_ff=24576, vocab=49152.
GPT-BigCode style: non-gated GELU FFN (d_ff = 4d).  MQA: the single KV head
is replicated across the model axis (documented in launch/sharding notes).
Full attention -> long_500k skipped.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, act="gelu", attn="full",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=256, vocab=512, act="gelu", attn="full",
    dtype="float32", remat=False,
)
