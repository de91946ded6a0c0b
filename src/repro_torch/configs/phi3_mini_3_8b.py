"""phi3-mini-3.8b  [dense] — RoPE SwiGLU, full MHA (kv=32).
Copied from ``repro.configs.phi3_mini_3_8b``.
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[arXiv:2404.14219; unverified]
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    max_seq=32_768 + 8,
)

SMOKE = ModelConfig(
    name="phi3-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    max_seq=128, remat=False,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention (dense MHA KV cache, no sub-quadratic mechanism)",
}
