"""granite-34b  [dense] — code model, MQA.
Copied from ``repro.configs.granite_34b``.
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]

GELU 2-matrix MLP (matches the 34B param count; 3-matrix SwiGLU at this
d_ff would be 46B).
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, mlp_kind="gelu",
    max_seq=32_768 + 8,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256, mlp_kind="gelu",
    max_seq=128, remat=False,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention (MQA, no window/latent/SSM structure)",
}
