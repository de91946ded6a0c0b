"""Closed-form operation / off-chip-byte counts for the paper's four
attention methods (MLA_rc, MLA_ru, MHA_l, MHA_s) plus the 'seq' and
'naive' orderings — the analytical backbone of the paper's Figs 2-4.

Copied from ``repro.hwmodel.attention_costs``: the port keeps its own
copy so it never imports the JAX package, and every function returns the
reference's value for the same arguments.

Conventions (matching the letter):
  * "operations" = FLOPs = 2 x MACs.
  * Off-chip accesses count weights (once per step, batch-shared), the
    KV / latent cache (read once, new entry written), and optionally
    activations in/out (``include_io``).  Intermediates are assumed to
    stay on-chip (the paper's fused-execution assumption; realized on the
    GPU by the paged CUDA kernels — see kernels/csrc/).
  * ``rope=False`` reproduces the paper exactly (it omits RoPE); the
    framework default is rope=True for deployment honesty.
  * Softmax is neglected in Fig 3 (the paper does the same) and modeled
    in ``roofline.py`` via ``softmax_flops``.
  * The ``impl`` names of the prefill costs are the cost model's own:
    'pallas' is the paged prefill kernel walking the block table in
    place (the port's K2), 'gather' the path that materializes the
    block-table view.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..core.mla import MLAConfig


@dataclasses.dataclass(frozen=True)
class MHAConfig:
    d_model: int
    n_heads: int
    qk_dim: int
    v_dim: int

    def param_count(self) -> int:
        return self.n_heads * self.d_model * (2 * self.qk_dim + self.v_dim) \
            + self.n_heads * self.v_dim * self.d_model


# DeepSeek-V3 instantiations (paper Table 1)
DSV3_MLA = MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                     kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                     v_head_dim=128)
MHA_L = MHAConfig(d_model=7168, n_heads=128, qk_dim=128, v_dim=128)
MHA_S = MHAConfig(d_model=4363, n_heads=128, qk_dim=77, v_dim=77)


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
                    table_entry_bytes: int = 4, dp_shards: int = 1,
                    cache_dtype_bytes: Optional[float] = None) -> Cost:
    """One decode step of one MLA layer. ``cache_len`` = L (incl. new token).

    ``paged_block > 0`` models the paged latent cache: reads happen in
    whole blocks (internal fragmentation rounds L up to a block multiple)
    and each step additionally streams the per-request block tables
    (ceil(L/bs) int32 entries per request).  Keeps the roofline honest for
    the continuous-batching runtime (runtime.engine).

    ``dp_shards > 1`` returns the PER-DEVICE cost of data-parallel serving
    (runtime.steps: batch/table/length rows sharded over the DP axes):
    every batch-proportional term — cache read/write, block-table
    traffic, per-token projections and scores — shrinks to the local
    batch ceil(B / dp_shards), while the WEIGHT bytes are unchanged (each
    device still streams the full weight set per step; the pool is
    replicated, but a device only reads the blocks its local rows
    reference).  This is the scale-out shape of the paper's bandwidth
    argument: DP scales the served batch while per-device cache traffic
    stays flat.

    ``cache_dtype_bytes`` overrides the per-ELEMENT byte width of the
    latent-cache terms only (read + write): a quantized {int8|fp8} pool
    stores 1-byte payloads plus two per-row f32 scales, which
    core.cache.cache_element_bytes folds into a fractional width.
    Weights, activations and spills stay at ``dtype_bytes`` — only the
    cache streams shrink, which is exactly the crossover shift
    auto_dispatch must see."""
    D, H, Q, K, dn, dr, dv = _dims(cfg, rope)
    if dp_shards < 1:
        raise ValueError(f"dp_shards must be >= 1, got {dp_shards}")
    B, L, w = -(-batch // dp_shards), cache_len, dtype_bytes
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


def rescale_multiplies(cfg: MLAConfig, *, cache_len: int, batch: int = 1,
                       paged_block: int = 1, rescale: str = "exp_add",
                       rope: bool = True) -> float:
    """Modeled per-layer count of online-softmax RESCALE multiplies in one
    decode step of the paged kernel (kernels.mla_decode): every block-tile
    update corrects the running accumulator (H x kv_lora) and denominator
    (H) by exp(m_prev - m_new).

      'mul'     — the textbook FlashAttention correction: one f32 multiply
                  per corrected element, B * n_tiles * H * (kv_lora + 1).
      'exp_add' — AMLA-style exponent-addition (arXiv:2509.25224): m is
                  quantized to integers in log2 space, so the correction
                  2^{-d} lands as an integer add into the f32 exponent
                  field — zero multiplies on the rescale path (the
                  per-element cost degrades to bitcast + integer add,
                  which shares no port with the floating-point multiplier).

    This isolates the term the AMLA trick deletes; it is NOT folded into
    :func:`mla_decode_cost` (which counts MAC FLOPs only, per the paper's
    convention) — tests assert the modeled count drops to zero."""
    if rescale not in ("exp_add", "mul"):
        raise ValueError(f"unknown rescale {rescale!r}")
    if rescale == "exp_add":
        return 0.0
    _, H, _, K, _, _, _ = _dims(cfg, rope)
    n_tiles = -(-cache_len // max(paged_block, 1))
    return float(batch * n_tiles * H * (K + 1))


def mla_verify_cost(cfg: MLAConfig, *, scheme: str, cache_len: int,
                    k: int, batch: int = 1, dtype_bytes: int = 2,
                    rope: bool = False, include_io: bool = False,
                    paged_block: int = 0, table_entry_bytes: int = 4,
                    dp_shards: int = 1,
                    cache_dtype_bytes: Optional[float] = None) -> Cost:
    """One SPECULATIVE-DECODE verify step of one MLA layer: q = k + 1
    query positions (the last sampled token + k draft tokens) scored
    against the same resident cache in one forward
    (runtime.steps.make_verify_step — the chunked-prefill machinery with
    chunk = k + 1).

    The amortization speculative decoding exists for, in MLA terms: the
    latent-cache read and every weight stream are paid ONCE for the whole
    window instead of once per token, while the per-token projections and
    scores scale with q.  ``cache_len`` counts the resident tokens BEFORE
    the window (query j attends cache_len + j + 1 positions); k = 0
    degrades to :func:`mla_decode_cost` up to the in-window causal terms.
    ``paged_block`` / ``dp_shards`` behave exactly as in
    :func:`mla_decode_cost` (whole-block reads + table traffic; per-device
    batch under data-parallel serving).  See also
    :func:`spec_break_even` for the accepted-length break-even this
    implies."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    D, H, Q, K, dn, dr, dv = _dims(cfg, rope)
    if dp_shards < 1:
        raise ValueError(f"dp_shards must be >= 1, got {dp_shards}")
    B, w, q = -(-batch // dp_shards), dtype_bytes, k + 1
    cw = dtype_bytes if cache_dtype_bytes is None else cache_dtype_bytes
    # mean attended length over the in-window causal ramp
    Lbar = cache_len + (q + 1) / 2
    L_end = cache_len + q                   # resident extent after the step
    fl: Dict[str, float] = {}
    by: Dict[str, float] = {}

    # ---- per-token projections: scale with the window ------------------
    fl["q_down"] = 2 * B * q * D * Q
    fl["kv_down"] = 2 * B * q * D * (K + dr)
    fl["attn_scores"] = 2 * B * H * q * Lbar * (K + dr)
    fl["attn_out"] = 2 * B * H * q * Lbar * K
    fl["v_up"] = 2 * B * q * H * K * dv
    fl["o_proj"] = 2 * B * q * H * dv * D
    # ---- batch- AND window-shared streams: paid once per round ----------
    by["w_common"] = (D * Q + D * (K + dr) + K * H * dv + H * dv * D) * w
    by["cache_read"] = B * cache_len * (K + dr) * cw
    by["cache_write"] = B * q * (K + dr) * cw
    if paged_block:
        n_blk = -(-L_end // paged_block)
        by["cache_read"] = B * n_blk * paged_block * (K + dr) * cw
        by["block_table"] = B * n_blk * table_entry_bytes

    if scheme == "seq":
        fl["q_up"] = 2 * B * q * Q * H * (dn + dr)
        fl["q_latent"] = 2 * B * q * H * dn * K
        by["w_scheme"] = (Q * H * (dn + dr) + K * H * dn) * w
    elif scheme == "rc":
        fl["q_up_rope"] = 2 * B * q * Q * H * dr
        fl["absorb_recompute"] = 2 * H * Q * dn * K   # batch/window-shared
        fl["q_latent"] = 2 * B * q * H * Q * K
        by["w_scheme"] = (Q * H * (dn + dr) + K * H * dn) * w
    elif scheme == "ru":
        fl["q_up_rope"] = 2 * B * q * Q * H * dr
        fl["q_latent"] = 2 * B * q * H * Q * K
        by["w_scheme"] = (H * Q * K + Q * H * dr) * w
    elif scheme == "naive":
        fl["q_up"] = 2 * B * q * Q * H * (dn + dr)
        fl["k_up"] = 2 * B * Lbar * K * H * dn
        fl["v_up_cache"] = 2 * B * Lbar * K * H * dv
        fl["attn_scores"] = 2 * B * H * q * Lbar * (dn + dr)
        fl["attn_out"] = 2 * B * H * q * Lbar * dv
        fl["v_up"] = 0.0
        by["w_scheme"] = (Q * H * (dn + dr) + K * H * dn) * w
        by["kv_spill"] = 2 * B * Lbar * H * (dn + dr + dv) * w
    else:
        raise ValueError(scheme)

    if include_io:
        by["io"] = 2 * B * q * D * w
    return Cost(sum(fl.values()), sum(by.values()),
                {**fl, **{f"B:{n}": v for n, v in by.items()}})


def spec_break_even(cfg: MLAConfig, *, scheme: str, cache_len: int, k: int,
                    batch: int = 1, dtype_bytes: int = 2,
                    paged_block: int = 0, dp_shards: int = 1,
                    draft_bytes_frac: float = 0.0,
                    cache_dtype_bytes: Optional[float] = None) -> Dict[str, float]:
    """Expected-accepted-length break-even of speculative decoding, on
    the bandwidth axis (the regime the paper places large-batch MLA
    decode in): one verify round emits E in [1, k+1] tokens for one
    verify step's bytes (+ the draft's, as ``draft_bytes_frac`` of a
    plain decode step per drafted token).  Spec wins when

        E  >  (verify.bytes + k * draft_frac * decode.bytes) / decode.bytes

    Returns the break-even E*, the per-emitted-token byte ratios at the
    extremes, and the raw byte counts — a serving report puts E* next to
    the measured mean accepted length so the runtime row and the model
    agree on when drafting pays."""
    verify = mla_verify_cost(cfg, scheme=scheme, cache_len=cache_len, k=k,
                             batch=batch, dtype_bytes=dtype_bytes,
                             paged_block=paged_block, dp_shards=dp_shards,
                             cache_dtype_bytes=cache_dtype_bytes)
    decode = mla_decode_cost(cfg, scheme=scheme, cache_len=cache_len,
                             batch=batch, dtype_bytes=dtype_bytes,
                             paged_block=paged_block, dp_shards=dp_shards,
                             cache_dtype_bytes=cache_dtype_bytes)
    round_bytes = verify.bytes + k * draft_bytes_frac * decode.bytes
    return {
        "verify_bytes": verify.bytes,
        "decode_bytes": decode.bytes,
        "round_bytes": round_bytes,
        "break_even_emitted": round_bytes / decode.bytes,
        "bytes_per_token_best": round_bytes / (k + 1),
        "bytes_per_token_worst": round_bytes,
        "amortization_at_full_accept": decode.bytes * (k + 1) / round_bytes,
    }


def mla_prefill_cost(cfg: MLAConfig, *, seq_len: int, batch: int = 1,
                     dtype_bytes: int = 2, rope: bool = False, causal: bool = True,
                     include_io: bool = True, cached_prefix: int = 0,
                     cache_dtype_bytes: Optional[float] = None) -> Cost:
    """Prefill of an L-token prompt; ``cached_prefix = P`` tokens are
    served by the radix prefix cache (runtime.prefix_cache): only the
    Ls = L - P suffix tokens are projected / written, the suffix queries
    still attend the FULL prompt (the shared prefix's latents are READ
    from the pool instead of recomputed).  P = 0 reproduces the plain
    prefill exactly; the causal score/PV term generalizes to the exact
    pair fraction (L^2 - P^2) / 2."""
    D, H, Q, K, dn, dr, dv = _dims(cfg, rope)
    B, L, w = batch, seq_len, dtype_bytes
    cw = dtype_bytes if cache_dtype_bytes is None else cache_dtype_bytes
    P = cached_prefix
    if not 0 <= P < max(L, 1):
        raise ValueError(f"cached_prefix {P} out of range for seq_len {L}")
    Ls = L - P
    att = 0.5 if causal else 1.0
    # query x key position pairs inside the causal mask, suffix rows only:
    # sum_{i=P..L-1}(i+1) ~ (L^2 - P^2)*att  (matches the paper's L^2/2
    # convention at P=0)
    pairs = (L * L - P * P) * att if causal else Ls * L
    fl = {
        "q_down": 2 * B * Ls * D * Q,
        "q_up": 2 * B * Ls * Q * H * (dn + dr),
        "kv_down": 2 * B * Ls * D * (K + dr),
        "k_up": 2 * B * Ls * K * H * dn,
        "v_up": 2 * B * Ls * K * H * dv,
        "attn_scores": 2 * B * H * pairs * (dn + dr),
        "attn_out": 2 * B * H * pairs * dv,
        "o_proj": 2 * B * Ls * H * dv * D,
    }
    by = {
        "weights": (D * Q + Q * H * (dn + dr) + D * (K + dr) + K * H * dn
                    + K * H * dv + H * dv * D) * w,
        "cache_write": B * Ls * (K + dr) * cw,
    }
    if P:
        # the shared prefix's compact latents stream in from the pool
        by["prefix_read"] = B * P * (K + dr) * cw
    if include_io:
        by["io"] = 2 * B * Ls * D * w
    return Cost(sum(fl.values()), sum(by.values()), {**fl, **{f"B:{k}": v for k, v in by.items()}})


def mla_prefill_chunk_cost(cfg: MLAConfig, *, seq_len: int, chunk: int,
                           paged_block: int, batch: int = 1,
                           dtype_bytes: int = 2, rope: bool = False,
                           cached_prefix: int = 0, impl: str = "pallas",
                           include_io: bool = True,
                           table_entry_bytes: int = 4,
                           cache_dtype_bytes: Optional[float] = None) -> Cost:
    """Chunked PAGED prefill of an L-token prompt, C tokens per chunk,
    over a block pool with ``paged_block``-token blocks.

    ``impl`` models the two chunk-attention paths of
    core.mla.mla_prefill_chunk_paged:

      'gather' — the reference path: every chunk MATERIALIZES the
        contiguous (B, W) block-table view in HBM (pool gather read +
        view write + attention re-read, W = the table extent rounded to
        whole blocks) and computes scores over the full view width —
        per-chunk bytes AND FLOPs scale with W regardless of how little
        of the prompt is resident yet.
      'pallas' — the kernel (kernels.mla_prefill): walks the block table
        in place, streaming only the blocks at-or-before the chunk's
        last valid position, once, plus the table entries themselves.
        No view is ever written; this is what restores the arithmetic
        intensity the paper's roofline assigns the compute-bound prefill
        phase (scores stay on-chip, the pool streams from HBM on-chip once).

    Weights are re-streamed once per chunk step (each chunk is its own
    device step).  ``cached_prefix = P`` tokens ride the radix prefix
    cache: only the suffix is projected/written, but every chunk still
    attends the resident prefix through the table.
    """
    if impl not in ("gather", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    if chunk < 1 or paged_block < 1:
        raise ValueError("chunk and paged_block must be >= 1")
    D, H, Q, K, dn, dr, dv = _dims(cfg, rope)
    B, L, w, P, C, bs = batch, seq_len, dtype_bytes, cached_prefix, chunk, \
        paged_block
    cw = dtype_bytes if cache_dtype_bytes is None else cache_dtype_bytes
    if not 0 <= P < max(L, 1):
        raise ValueError(f"cached_prefix {P} out of range for seq_len {L}")
    Ls = L - P
    n_chunks = -(-Ls // C)
    # per-suffix-token projections (identical across impls; the 'seq'
    # absorption: q_nope -> latent via W_uk, PV output via W_uv)
    fl: Dict[str, float] = {
        "q_down": 2 * B * Ls * D * Q,
        "q_up": 2 * B * Ls * Q * H * (dn + dr),
        "q_latent": 2 * B * Ls * H * dn * K,
        "kv_down": 2 * B * Ls * D * (K + dr),
        "v_up": 2 * B * Ls * H * K * dv,
        "o_proj": 2 * B * Ls * H * dv * D,
    }
    w_bytes = (D * Q + Q * H * (dn + dr) + D * (K + dr) + K * H * dn
               + K * H * dv + H * dv * D) * w
    by: Dict[str, float] = {
        "weights": w_bytes * n_chunks,      # re-streamed every chunk step
        "cache_write": B * Ls * (K + dr) * cw,
    }
    W = -(-L // bs) * bs                    # table extent, whole blocks
    fl_attn = rd_pool = rd_table = view_bytes = 0.0
    for k in range(n_chunks):
        c_k = min(C, Ls - k * C)            # valid rows this chunk
        end_k = P + k * C + c_k             # newest attendable position + 1
        ext_k = -(-end_k // bs) * bs        # resident extent, whole blocks
        if impl == "pallas":
            fl_attn += 2 * B * H * c_k * ext_k * ((K + dr) + K)
            rd_pool += B * ext_k * (K + dr) * cw
            rd_table += B * (ext_k // bs) * table_entry_bytes
        else:
            # scores/PV run over the FULL gathered view width W (masked
            # entries are still computed), and the view round-trips HBM:
            # pool gather read (cache width) + dequantized f32 view
            # write + attention re-read (compute width — the gather path
            # materializes the view in f32/compute dtype, not int8).
            fl_attn += 2 * B * H * c_k * W * ((K + dr) + K)
            rd_pool += B * W * (K + dr) * cw
            view_bytes += 2 * B * W * (K + dr) * w
    fl["attn_scores_pv"] = fl_attn
    by["cache_read"] = rd_pool
    if impl == "pallas":
        by["block_table"] = rd_table
    else:
        by["gather_materialize"] = view_bytes
    if include_io:
        by["io"] = 2 * B * Ls * D * w
    return Cost(sum(fl.values()), sum(by.values()),
                {**fl, **{f"B:{k}": v for k, v in by.items()}})


def prefix_hit_savings(cfg: MLAConfig, *, seq_len: int, cached_prefix: int,
                       batch: int = 1, dtype_bytes: int = 2,
                       rope: bool = False) -> Dict[str, float]:
    """FLOPs / off-chip bytes a prefix-cache hit saves on one prefill,
    total and per shared token — the analytical counterpart of the
    runtime's hit-rate metric (a serving report puts the two side by side).  The decode
    phase is unchanged by sharing (same L per request); the win is the
    prompt recompute + re-store that never happens, which is what moves
    TTFT (see core.schemes.prefill_time)."""
    base = mla_prefill_cost(cfg, seq_len=seq_len, batch=batch,
                            dtype_bytes=dtype_bytes, rope=rope)
    hit = mla_prefill_cost(cfg, seq_len=seq_len, batch=batch,
                           dtype_bytes=dtype_bytes, rope=rope,
                           cached_prefix=cached_prefix)
    P = max(cached_prefix, 1)
    return {
        "flops_saved": base.flops - hit.flops,
        "bytes_saved": base.bytes - hit.bytes,
        "flops_saved_per_token": (base.flops - hit.flops) / P,
        "bytes_saved_per_token": (base.bytes - hit.bytes) / P,
        "flops_frac": 1.0 - hit.flops / max(base.flops, 1.0),
        "bytes_frac": 1.0 - hit.bytes / max(base.bytes, 1.0),
    }


# ------------------------------------------------------------------ MHA ----


def mha_decode_cost(cfg: MHAConfig, *, cache_len: int, batch: int = 1,
                    dtype_bytes: int = 2, include_io: bool = False) -> Cost:
    D, H, dq, dv = cfg.d_model, cfg.n_heads, cfg.qk_dim, cfg.v_dim
    B, L, w = batch, cache_len, dtype_bytes
    fl = {
        "qkv_proj": 2 * B * D * H * (2 * dq + dv),
        "attn_scores": 2 * B * H * L * dq,
        "attn_out": 2 * B * H * L * dv,
        "o_proj": 2 * B * H * dv * D,
    }
    by = {
        "weights": (D * H * (2 * dq + dv) + H * dv * D) * w,
        "cache_read": B * L * H * (dq + dv) * w,
        "cache_write": B * H * (dq + dv) * w,
    }
    if include_io:
        by["io"] = 2 * B * D * w
    return Cost(sum(fl.values()), sum(by.values()), {**fl, **{f"B:{k}": v for k, v in by.items()}})


def mha_prefill_cost(cfg: MHAConfig, *, seq_len: int, batch: int = 1,
                     dtype_bytes: int = 2, causal: bool = True,
                     include_io: bool = True) -> Cost:
    D, H, dq, dv = cfg.d_model, cfg.n_heads, cfg.qk_dim, cfg.v_dim
    B, L, w = batch, seq_len, dtype_bytes
    att = 0.5 if causal else 1.0
    fl = {
        "qkv_proj": 2 * B * L * D * H * (2 * dq + dv),
        "attn_scores": 2 * B * H * L * L * dq * att,
        "attn_out": 2 * B * H * L * L * dv * att,
        "o_proj": 2 * B * L * H * dv * D,
    }
    by = {
        "weights": (D * H * (2 * dq + dv) + H * dv * D) * w,
        "cache_write": B * L * H * (dq + dv) * w,
    }
    if include_io:
        by["io"] = 2 * B * L * D * w
    return Cost(sum(fl.values()), sum(by.values()), {**fl, **{f"B:{k}": v for k, v in by.items()}})


# ------------------------------------------------- Fig 2: ordering study ----


def score_chain_ops(cfg: MLAConfig, order: str, cache_len: int,
                    batch: int = 1, rope: bool = False) -> float:
    """FLOPs of  Q_l . W_up^Q . W_up^{K,T} . C^T  under a given product
    order (Fig 2).  Orders: '123' left-to-right, '132' naive, '213' absorb-
    recompute, 'ru' absorb-reuse (precomputed)."""
    _, H, Q, K, dn, dr, _ = _dims(cfg, rope)
    B, L = batch, cache_len
    if order == "123":
        return 2 * (B * Q * H * dn + B * H * dn * K + B * H * K * L)
    if order == "132":
        return 2 * (B * Q * H * dn + B * L * K * H * dn + B * H * dn * L)
    if order == "213":
        return 2 * (H * Q * dn * K + B * H * Q * K + B * H * K * L)
    if order == "ru":
        return 2 * (B * H * Q * K + B * H * K * L)
    raise ValueError(order)


def softmax_flops(n_heads: int, cache_len: int, batch: int = 1,
                  ops_per_elem: int = 5) -> float:
    """max, sub, exp, sum, div — ~5 vector ops per score element."""
    return ops_per_elem * batch * n_heads * cache_len
