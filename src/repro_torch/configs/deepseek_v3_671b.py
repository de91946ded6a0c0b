"""deepseek-v3-671b — the paper's Table-1 instantiation.
Copied from ``repro.configs.deepseek_v3_671b``.
61L d_model=7168 128H, MLA q_lora=1536 kv_lora=512, MoE 1 shared + 256
routed top-8, d_ff(expert)=2048, first 3 layers dense (d_ff=18432).
[arXiv:2412.19437]

Its MLA widths are DeepSeek-V2's (128 heads, q_lora 1536, kv_lora 512,
nope 128, rope 64, v_head 128), so the paged kernels take it unchanged;
d_model, the experts and the dense prefix differ.
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    first_dense_layers=3, first_dense_d_ff=18432,
    max_seq=524_288 + 8,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256,
    attn_kind="mla", q_lora_rank=48, kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=1,
    first_dense_layers=3, first_dense_d_ff=128,
    max_seq=128, remat=False,
)

SKIP_SHAPES: dict = {}
