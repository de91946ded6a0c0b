"""jamba-1.5-large-398b  [hybrid]  — Mamba+attn 1:7 interleave, MoE 16e top-2.
Copied from ``repro.configs.jamba_1_5_large_398b``.
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536
[arXiv:2403.19887; hf]

Jamba period = 8 layers: attention at offset 3, Mamba elsewhere; MoE on
every 2nd layer (the rest dense MLP).  72 layers = 9 periods (scanned).
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    attn_period=8, attn_offset=3, moe_period=2,
    n_experts=16, top_k=2, moe_d_ff=24576,
    d_state=16, conv_width=4, expand=2,
    max_seq=524_288 + 8,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=16, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    attn_period=8, attn_offset=3, moe_period=2,
    n_experts=4, top_k=2, moe_d_ff=64,
    d_state=8, conv_width=4, expand=2,
    max_seq=128, remat=False,
)

SKIP_SHAPES: dict = {}  # hybrid SSM: O(1) mamba state + bounded GQA layers
