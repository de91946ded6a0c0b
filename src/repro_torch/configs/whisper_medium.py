"""whisper-medium  [audio] — encoder-decoder, conv frontend STUB.
Copied from ``repro.configs.whisper_medium``.
24L(dec)+24L(enc) d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]

Callers provide precomputed frame embeddings (B, 1500, d_model) in place
of the log-mel conv stack.  Decoder positions beyond the trained 448 are
a dry-run formality.  Cross-attention K/V computed once at prefill = the
extreme 'reuse' point of the paper's rc/ru spectrum.
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, mlp_kind="gelu",
    n_enc_layers=24, n_frames=1500,
    max_seq=32_768 + 8,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, mlp_kind="gelu",
    n_enc_layers=2, n_frames=16,
    max_seq=128, remat=False,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention decoder (dense KV cache; trained ctx 448)",
}
