"""xlstm-350m  [ssm] — sLSTM + mLSTM blocks (attention-free, O(1) state).
Copied from ``repro.configs.xlstm_350m``.
24L d_model=1024 4H d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]

7:1 mLSTM:sLSTM ratio (one sLSTM per 8 layers).  No KV cache of any kind —
the O(1)-state limit point of the paper's OI analysis (DESIGN.md §5).
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8, expand=2,
    max_seq=524_288 + 8,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=256,
    slstm_every=8, expand=2,
    max_seq=128, remat=False,
)

SKIP_SHAPES: dict = {}  # attention-free: all shapes run
