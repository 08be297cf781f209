"""h2o-danube-1.8b [arXiv:2401.16818; hf] — dense, llama+mistral mix, SWA.

24L, d_model=2560, 32H (GQA kv=8), d_ff=6912, vocab=32000, sliding-window
attention (window 4096) -> sub-quadratic: runs the long_500k cell.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, act="swiglu", attn="swa", window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, act="swiglu", attn="swa", window=32,
    dtype="float32", remat=False,
)
