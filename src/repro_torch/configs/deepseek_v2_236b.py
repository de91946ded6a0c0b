"""deepseek-v2-236b  [moe] — the paper's native architecture (MLA + MoE).
Copied from ``repro.configs.deepseek_v2_236b``.
60L d_model=5120 128H d_ff=1536(expert) vocab=102400
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128
MoE: 2 shared + 160 routed experts, top-6; first layer dense (d_ff=12288)
[arXiv:2405.04434; hf]

This is the hillclimb target for the paper's technique: both MLA decode
schemes (rc/ru/seq/naive) are runtime-selectable on this config.
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, top_k=6, moe_d_ff=1536, n_shared_experts=2,
    first_dense_layers=1, first_dense_d_ff=12288,
    max_seq=524_288 + 8,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256,
    attn_kind="mla", q_lora_rank=48, kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=2,
    first_dense_layers=1, first_dense_d_ff=128,
    max_seq=128, remat=False,
)

SKIP_SHAPES: dict = {}  # MLA latent cache (576 B/token/layer): 500k decode
# is exactly the paper's headline benefit — runs.
