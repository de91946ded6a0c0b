"""internvl2-26b  [vlm] — InternViT frontend STUB + InternLM2-20B backbone.
Copied from ``repro.configs.internvl2_26b``.
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]

``input_specs`` supplies 1024 precomputed patch embeddings prepended to
(seq - 1024) text tokens for train/prefill; decode shapes are text-only
with the image prefix already in cache (DESIGN.md §6).
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    n_patches=1024,
    max_seq=32_768 + 8,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    n_patches=8,
    max_seq=128, remat=False,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention backbone (GQA KV cache, no sub-quadratic mechanism)",
}
