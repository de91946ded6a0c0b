"""starcoder2-7b  [dense] — GQA, RoPE, code model.
Copied from ``repro.configs.starcoder2_7b``.
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173; hf]

GELU 2-matrix MLP (starcoder2 uses gelu; matches the 7B count).
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152, mlp_kind="gelu",
    max_seq=32_768 + 8,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=4, d_model=72, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, mlp_kind="gelu",
    max_seq=128, remat=False,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention (GQA KV cache, no sub-quadratic mechanism)",
}
