"""nemotron-4-340b [arXiv:2402.16819] — dense, GQA, squared-ReLU.

96L, d_model=18432, 96H (GQA kv=8), d_ff=73728, vocab=256000.
Full attention -> long_500k cell skipped (documented in DESIGN.md).
FSDP on: 340B params exceed pure-TP capacity on 256 chips.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, act="relu2", attn="full",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, act="relu2", attn="full",
    dtype="float32", remat=False,
)
