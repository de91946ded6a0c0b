"""gemma3-1b  [dense] — 5:1 local:global attention, 128k context.
Copied from ``repro.configs.gemma3_1b``.
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 head_dim=256
[hf:google/gemma-3-1b-pt; unverified]

local_global_period=6: five sliding-window (512) layers then one global
layer (rope base 1M).  long_500k runs: 5/6 of the cache is bounded at the
window; the global layers use the seq-sharded distributed decode path.
"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    local_global_period=6, window=512, global_rope_base=1_000_000.0,
    embed_scale=True,
    max_seq=524_288 + 8,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=12, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256,
    local_global_period=6, window=8, global_rope_base=1_000_000.0,
    embed_scale=True,
    max_seq=128, remat=False,
)

SKIP_SHAPES: dict = {}  # 5/6 layers window-bounded; globals seq-sharded
