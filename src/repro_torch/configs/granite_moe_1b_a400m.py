"""granite-moe-1b-a400m  [moe] — 32 experts top-8, every layer MoE.
Copied from ``repro.configs.granite_moe_1b_a400m``.
24L d_model=1024 16H (GQA kv=8) d_ff=512(expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=32, top_k=8, moe_d_ff=512,
    max_seq=32_768 + 8,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=256,
    n_experts=8, top_k=4, moe_d_ff=32,
    max_seq=128, remat=False,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention (GQA KV cache, no sub-quadratic mechanism)",
}
