"""(Copied, in part, from ``repro.hwmodel.attention_costs``.)

Closed-form operation / off-chip-byte counts of one MLA decode step under
the 'seq', 'rc', 'ru' and 'naive' orderings — what ``core.schemes``
prices to pick a scheme.  The JAX package's prefill, verify, MHA and
ordering-study costs come with the port features that use them.

Conventions (matching the letter):
  * "operations" = FLOPs = 2 x MACs.
  * Off-chip accesses count weights (once per step, batch-shared), the
    KV / latent cache (read once, new entry written), and optionally
    activations in/out (``include_io``).  Intermediates are assumed to
    stay on-chip (the paper's fused-execution assumption; realized on the
    GPU by the paged CUDA kernels — see kernels/csrc/).
  * ``rope=False`` reproduces the paper exactly (it omits RoPE); the
    framework default is rope=True for deployment honesty.
  * Softmax is neglected (the paper does the same).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..core.mla import MLAConfig


@dataclasses.dataclass
class Cost:
    flops: float
    bytes: float
    breakdown: Dict[str, float]

    @property
    def oi(self) -> float:
        return self.flops / max(self.bytes, 1.0)


# ------------------------------------------------------------------ MLA ----


def _dims(cfg: MLAConfig, rope: bool):
    dr = cfg.qk_rope_dim if rope else 0
    return cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank, \
        cfg.qk_nope_dim, dr, cfg.v_head_dim


def mla_decode_cost(cfg: MLAConfig, *, scheme: str, cache_len: int,
                    batch: int = 1, dtype_bytes: int = 2, rope: bool = False,
                    include_io: bool = False, paged_block: int = 0,
                    table_entry_bytes: int = 4,
                    cache_dtype_bytes: Optional[float] = None) -> Cost:
    """One decode step of one MLA layer. ``cache_len`` = L (incl. new token).

    ``paged_block > 0`` models the paged latent cache: reads happen in
    whole blocks (internal fragmentation rounds L up to a block multiple)
    and each step additionally streams the per-request block tables
    (ceil(L/bs) int32 entries per request).  Keeps the roofline honest for
    the continuous-batching runtime (runtime.engine).

    ``cache_dtype_bytes`` overrides the per-ELEMENT byte width of the
    latent-cache terms only (read + write): a quantized {int8|fp8} pool
    stores 1-byte payloads plus two per-row f32 scales, which
    core.cache.cache_element_bytes folds into a fractional width.
    Weights, activations and spills stay at ``dtype_bytes`` — only the
    cache streams shrink, which is exactly the crossover shift
    auto_dispatch must see."""
    D, H, Q, K, dn, dr, dv = _dims(cfg, rope)
    B, L, w = batch, cache_len, dtype_bytes
    cw = dtype_bytes if cache_dtype_bytes is None else cache_dtype_bytes
    fl: Dict[str, float] = {}
    by: Dict[str, float] = {}

    # ---- common projections (per token) --------------------------------
    fl["q_down"] = 2 * B * D * Q
    fl["kv_down"] = 2 * B * D * (K + dr)
    fl["attn_scores"] = 2 * B * H * L * (K + dr)
    fl["attn_out"] = 2 * B * H * L * K
    fl["v_up"] = 2 * B * H * K * dv
    fl["o_proj"] = 2 * B * H * dv * D
    by["w_common"] = (D * Q + D * (K + dr) + K * H * dv + H * dv * D) * w
    by["cache_read"] = B * L * (K + dr) * cw
    by["cache_write"] = B * (K + dr) * cw
    if paged_block:
        n_blk = -(-L // paged_block)
        by["cache_read"] = B * n_blk * paged_block * (K + dr) * cw
        by["block_table"] = B * n_blk * table_entry_bytes

    # ---- scheme-specific nope-query transform --------------------------
    if scheme == "seq":                       # 1->2->3, factored
        fl["q_up"] = 2 * B * Q * H * (dn + dr)
        fl["q_latent"] = 2 * B * H * dn * K
        by["w_scheme"] = (Q * H * (dn + dr) + K * H * dn) * w
    elif scheme == "rc":                      # 2->1->3, recompute absorb
        fl["q_up_rope"] = 2 * B * Q * H * dr
        fl["absorb_recompute"] = 2 * H * Q * dn * K  # batch-shared!
        fl["q_latent"] = 2 * B * H * Q * K
        by["w_scheme"] = (Q * H * (dn + dr) + K * H * dn) * w
    elif scheme == "ru":                      # precomputed absorb, streamed
        fl["q_up_rope"] = 2 * B * Q * H * dr
        fl["q_latent"] = 2 * B * H * Q * K
        by["w_scheme"] = (H * Q * K + Q * H * dr) * w
    elif scheme == "naive":                   # 1->3->2, up-project cache
        fl["q_up"] = 2 * B * Q * H * (dn + dr)
        fl["k_up"] = 2 * B * L * K * H * dn
        fl["v_up_cache"] = 2 * B * L * K * H * dv
        # attention runs in the full space instead of latent:
        fl["attn_scores"] = 2 * B * H * L * (dn + dr)
        fl["attn_out"] = 2 * B * H * L * dv
        fl["v_up"] = 0.0
        by["w_scheme"] = (Q * H * (dn + dr) + K * H * dn) * w
        # up-projected K/V do not fit on-chip for large L: spilled + re-read
        by["kv_spill"] = 2 * B * L * H * (dn + dr + dv) * w
    else:
        raise ValueError(scheme)

    if include_io:
        by["io"] = 2 * B * D * w
    return Cost(sum(fl.values()), sum(by.values()), {**fl, **{f"B:{k}": v for k, v in by.items()}})
