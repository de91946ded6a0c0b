"""Sublayer bodies: (pre-norm mixer) + (pre-norm FFN), dispatched on the
``Sub`` descriptor (port of ``repro.models.blocks``).

    sub_defs(cfg, desc, d_ff)                -> param defs
    sub_apply(params, cfg, desc, x, ctx)     -> (x, cache, aux)
    sub_cache(cfg, desc, batch, capacity, ...)    this sublayer's
                                                  contiguous cache
    sub_paged_cache(cfg, desc, ..., device)  -> this sublayer's paged pool

Mixers: MLA attention, the attention families (dense MHA / GQA / MQA
with an optional sliding window) and the recurrent mixers (Mamba, mLSTM,
sLSTM), each with a dense, MoE or no FFN.  Modes: 'train' and 'prefill'
over the whole sequence (attention dense with ``impl='ref'``, in
``core.chunked_attention``'s block-pair walk with ``impl='chunked'``, in
the flash-attention kernels with ``impl='kernel'``; the recurrent mixers
ignore ``impl``; 'prefill' also returns the decode state: MLA's latent
cache, the others' KV cache, a recurrent layer's state), 'decode'
(contiguous when ``ctx.lengths`` is None, else paged, MLA only) and
'prefill_chunk' (paged, MLA only).  Contiguous decode updates every
cache and state in place.  The paged modes also run sharded over a
(data, model) mesh (``Ctx.shard``): this DP shard's rows, heads and the
FFN's hidden dim and experts split over 'model' (``core.mla``,
``models.moe``, ``nn.layers.mlp``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core import cache as cachelib
from ..core import mla as mlalib
from ..core.attention import gqa_attention, gqa_decode
from ..core.chunked_attention import chunked_attention_pairs
from ..kernels import ops as kops
from ..nn import layers as nl
from ..nn.module import P
from . import mamba as mambalib
from . import moe as moelib
from . import xlstm as xlstmlib
from .common import ModelConfig, Sub

MODES = ("decode", "prefill_chunk", "prefill", "train")
IMPLS = ("ref", "chunked", "kernel")
# engine/model ``impl`` -> the decode / chunk attention path of core.mla
# (the reference's '_mla_step' and '_mla_chunk' gather under 'chunked')
_MLA_IMPL = {"ref": "gather", "chunked": "gather", "kernel": "kernel"}
# recurrent mixer -> (defs, sequence forward, decode step)
_RECURRENT = {
    "mamba": (mambalib.mamba_defs, mambalib.mamba_forward,
              mambalib.mamba_step),
    "mlstm": (xlstmlib.mlstm_defs, xlstmlib.mlstm_forward,
              xlstmlib.mlstm_step),
    "slstm": (xlstmlib.slstm_defs, xlstmlib.slstm_forward,
              xlstmlib.slstm_step),
}


@dataclasses.dataclass
class Ctx:
    mode: str                       # decode | prefill_chunk | prefill | train
    impl: str = "ref"               # attention impl, one of IMPLS
    scheme: str = "seq"             # MLA execution scheme
    positions: Any = None           # (B, L) int — train / prefill
    cache: Optional[Dict] = None    # this sublayer's cache or paged pool
    index: int = 0                  # contiguous decode: tokens cached
    capacity: int = 0               # prefill: S of the returned cache
    block_tables: Any = None        # (B, max_blocks) int32 — paged
    lengths: Any = None             # (B,) int32 — paged, ragged
    n_valid: Any = None             # (B,) int32 — chunked prefill only
    shard: Any = None               # nn.sharding.Shard under a mesh


def _check_mixer(desc: Sub) -> None:
    if desc.mixer != "attn" and desc.mixer not in _RECURRENT:
        raise ValueError(desc.mixer)


def _attn_defs(cfg: ModelConfig) -> Dict:
    if cfg.attn_kind == "mla":
        return mlalib.mla_defs(cfg.mla_config())
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    return {
        "w_q": P((D, H, dh), ("embed", "heads", None)),
        "w_k": P((D, Hkv, dh), ("embed", "kv_heads", None)),
        "w_v": P((D, Hkv, dh), ("embed", "kv_heads", None)),
        "w_o": P((H, dh, D), ("heads", None, "embed")),
    }


def sub_defs(cfg: ModelConfig, desc: Sub, d_ff: Optional[int] = None) -> Dict:
    _check_mixer(desc)
    mixer = _attn_defs(cfg) if desc.mixer == "attn" else \
        _RECURRENT[desc.mixer][0](cfg)
    d: Dict = {"ln1": nl.rmsnorm_defs(cfg.d_model), "attn": mixer}
    if desc.ffn != "none":
        d["ln2"] = nl.rmsnorm_defs(cfg.d_model)
        if desc.ffn == "moe":
            d["ffn"] = moelib.moe_defs(cfg)
        else:
            d["ffn"] = nl.mlp_defs(cfg.d_model, d_ff or cfg.d_ff,
                                   kind=cfg.mlp_kind)
    return d


def sub_cache(cfg: ModelConfig, desc: Sub, batch: int, capacity: int,
              dtype=torch.bfloat16, device="cuda") -> Dict:
    """Contiguous decode state of one sublayer: its (B, S) latent cache
    (MLA) or KV cache, or a recurrent layer's state (no capacity axis;
    Mamba's conv state in ``dtype``, the rest f32).  A windowed layer's
    capacity is min(capacity, cfg.max_seq), as in the reference."""
    _check_mixer(desc)
    if desc.mixer == "mamba":
        return mambalib.mamba_state_init(cfg, batch, dtype, device)
    if desc.mixer == "mlstm":
        return xlstmlib.mlstm_state_init(cfg, batch, device)
    if desc.mixer == "slstm":
        return xlstmlib.slstm_state_init(cfg, batch, device)
    if cfg.attn_kind == "mla":
        return cachelib.latent_cache(batch, capacity, cfg.kv_lora_rank,
                                     cfg.qk_rope_dim, dtype, device)
    eff_cap = capacity if desc.window is None else min(capacity, cfg.max_seq)
    return cachelib.kv_cache(batch, eff_cap, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype, device)


def sub_paged_cache(cfg: ModelConfig, desc: Sub, num_blocks: int,
                    block_size: int, dtype=torch.bfloat16, device="cuda",
                    cache_dtype: Optional[str] = None) -> Dict:
    """Paged decode state of one sublayer: its latent block pool
    (quantized with scale leaves for ``cache_dtype`` 'int8' / 'fp8').
    Only MLA latent caches page, as in the reference; other mixers raise
    — serve those models through the contiguous path."""
    if desc.mixer == "attn" and cfg.attn_kind == "mla":
        return cachelib.paged_latent_cache(num_blocks, block_size,
                                           cfg.kv_lora_rank,
                                           cfg.qk_rope_dim, dtype, device,
                                           cache_dtype)
    raise NotImplementedError(
        f"paged serving requires MLA attention sublayers, got "
        f"mixer={desc.mixer!r} attn_kind={cfg.attn_kind!r}")


AUX_KEYS = ("balance", "z_loss", "dropped_frac")


def _check_seq_impl(ctx: Ctx) -> None:
    if ctx.impl not in IMPLS:
        raise NotImplementedError(
            f"{ctx.mode} impl {ctx.impl!r}: the port runs {IMPLS}")


def _flash(q, k, v, desc: Sub, softmax_scale=None):
    """The attention of a train / prefill layer in the flash-attention
    kernels (K4 forward; K5 / K6 under autograd): (B, L, H, D) operands,
    handed over as (B, H, L, D) views."""
    return kops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        impl="kernel", causal=desc.causal, window=desc.window,
        softmax_scale=softmax_scale).transpose(1, 2)


def _gqa_seq(params, cfg: ModelConfig, desc: Sub, x, ctx: Ctx):
    """Train / prefill forward of one GQA sublayer.  x: (B, L, D)
    normalized input.  Returns (out, cache): in 'prefill' mode a KV cache
    of ``ctx.capacity`` (or L) positions holding the L entries, else
    None."""
    B, L, _ = x.shape
    q = torch.einsum("bld,dhk->blhk", x, params["w_q"].to(x.dtype))
    k = torch.einsum("bld,dhk->blhk", x, params["w_k"].to(x.dtype))
    v = torch.einsum("bld,dhk->blhk", x, params["w_v"].to(x.dtype))
    q = nl.apply_rope(q, ctx.positions, desc.rope_base)
    k = nl.apply_rope(k, ctx.positions, desc.rope_base)
    if ctx.impl == "kernel":
        o = _flash(q, k, v, desc)
    elif ctx.impl == "chunked":
        o = chunked_attention_pairs(q, k, v, desc.causal, desc.window, 0,
                                    None)
    else:
        o = gqa_attention(q, k, v, causal=desc.causal, window=desc.window,
                          q_positions=ctx.positions[0],
                          k_positions=ctx.positions[0])
    out = torch.einsum("blhk,hkd->bld", o, params["w_o"].to(x.dtype))
    if ctx.mode != "prefill":
        return out, None
    cache = cachelib.kv_cache(B, ctx.capacity or L, cfg.n_kv_heads,
                              cfg.resolved_head_dim, x.dtype, x.device)
    return out, cachelib.update_kv(cache, k, v, 0)


def _gqa_step(params, cfg: ModelConfig, desc: Sub, x_t, ctx: Ctx):
    """Contiguous decode of one GQA sublayer.  x_t: (B, D) normalized
    input; the new token's k / v are written at ``ctx.index`` in place.
    Returns (out, cache)."""
    B = x_t.shape[0]
    pos = torch.full((B, 1), ctx.index, dtype=torch.int64, device=x_t.device)
    q = torch.einsum("bd,dhk->bhk", x_t, params["w_q"].to(x_t.dtype))
    k = torch.einsum("bd,dhk->bhk", x_t, params["w_k"].to(x_t.dtype))
    v = torch.einsum("bd,dhk->bhk", x_t, params["w_v"].to(x_t.dtype))
    q = nl.apply_rope(q[:, None], pos, desc.rope_base)[:, 0]
    k = nl.apply_rope(k[:, None], pos, desc.rope_base)[:, 0]
    cache = cachelib.update_kv(ctx.cache, k[:, None], v[:, None], ctx.index)
    o = gqa_decode(q, cache["k"], cache["v"], ctx.index, window=desc.window)
    return torch.einsum("bhk,hkd->bd", o, params["w_o"].to(x_t.dtype)), cache


def _mla_seq(params, cfg: ModelConfig, desc: Sub, x, ctx: Ctx):
    """Train / prefill forward of one MLA sublayer over the whole sequence.
    x: (B, L, D) normalized input.  Returns (out, cache): in 'prefill'
    mode a contiguous latent cache of ``ctx.capacity`` (or L) positions
    holding the L entries, else None."""
    attn_fn = None
    if ctx.impl == "kernel":
        def attn_fn(q, k, v, softmax_scale):
            return _flash(q, k, v, desc, softmax_scale)
    elif ctx.impl == "chunked":
        def attn_fn(q, k, v, softmax_scale):
            return chunked_attention_pairs(q, k, v, desc.causal,
                                           desc.window, 0, softmax_scale)
    mcfg = cfg.mla_config()
    prefill = ctx.mode == "prefill"
    out, entries = mlalib.mla_prefill(params, mcfg, x, ctx.positions,
                                      attn_fn=attn_fn, return_cache=prefill)
    if not prefill:
        return out, None
    B, L, _ = x.shape
    cache = cachelib.latent_cache(B, ctx.capacity or L, mcfg.kv_lora_rank,
                                  mcfg.qk_rope_dim, x.dtype, x.device)
    return out, cachelib.update_latent(cache, entries["ckv"],
                                       entries["krope"], 0)


def _mla_mixer(params, cfg: ModelConfig, desc: Sub, h, ctx: Ctx):
    if ctx.mode in ("train", "prefill"):
        return _mla_seq(params, cfg, desc, h, ctx)
    if ctx.mode == "decode" and ctx.lengths is None:
        return mlalib.mla_decode(params, cfg.mla_config(), h, ctx.cache,
                                 ctx.index, scheme=ctx.scheme,
                                 impl=_MLA_IMPL[ctx.impl])
    if ctx.mode == "decode":
        return mlalib.mla_decode_paged(
            params, cfg.mla_config(), h, ctx.cache, ctx.block_tables,
            ctx.lengths, scheme=ctx.scheme, impl=_MLA_IMPL[ctx.impl],
            shard=ctx.shard)
    return mlalib.mla_prefill_chunk_paged(
        params, cfg.mla_config(), h, ctx.cache, ctx.block_tables,
        ctx.lengths, ctx.n_valid, scheme=ctx.scheme,
        impl=_MLA_IMPL[ctx.impl], shard=ctx.shard)


def _recurrent_mixer(params, cfg: ModelConfig, desc: Sub, h, ctx: Ctx):
    """A Mamba / mLSTM / sLSTM mixer: the sequence forward (returning the
    decode state in 'prefill' mode) or one decode step, whose new state
    overwrites ``ctx.cache`` in place."""
    _, forward, step = _RECURRENT[desc.mixer]
    if ctx.mode == "decode":
        a, new = step(params, cfg, h, ctx.cache)
        return a, cachelib.update_state(ctx.cache, new)
    return forward(params, cfg, h, return_state=ctx.mode == "prefill")


def sub_apply(params, cfg: ModelConfig, desc: Sub, x, ctx: Ctx):
    """x: (B, D) for decode, (B, C, D) for prefill_chunk, (B, L, D) for
    train and prefill.  Returns (x, cache, aux) — aux holds f32 scalars
    (zeros without a router); cache is the new contiguous cache or state
    in prefill mode, the updated cache, state or pool in the decode
    modes, None in train mode."""
    _check_mixer(desc)
    if ctx.mode not in MODES:
        raise NotImplementedError(
            f"mode {ctx.mode!r}: the port runs {MODES} only (ROADMAP.md)")
    if ctx.mode in ("train", "prefill"):
        _check_seq_impl(ctx)
    mla = desc.mixer == "attn" and cfg.attn_kind == "mla"
    if ctx.mode == "prefill_chunk" and not mla:
        raise NotImplementedError(
            "chunked paged prefill requires MLA attention sublayers")
    if ctx.mode == "decode" and ctx.lengths is not None and not mla:
        raise NotImplementedError(
            "paged decode requires MLA attention sublayers")
    if ctx.shard is not None and ctx.lengths is None:
        raise NotImplementedError(
            f"mode {ctx.mode!r} under a mesh: only the paged MLA steps "
            f"are sharded in the port (ROADMAP.md)")
    h = nl.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mla:
        a, pool = _mla_mixer(params["attn"], cfg, desc, h, ctx)
    elif desc.mixer != "attn":
        a, pool = _recurrent_mixer(params["attn"], cfg, desc, h, ctx)
    else:
        fn = _gqa_step if ctx.mode == "decode" else _gqa_seq
        a, pool = fn(params["attn"], cfg, desc, h, ctx)
    x = x + a

    aux = {k: x.new_zeros((), dtype=torch.float32) for k in AUX_KEYS}
    if desc.ffn != "none":
        h = nl.rmsnorm(params["ln2"], x, cfg.norm_eps)
        if desc.ffn == "moe":
            f, aux = moelib.moe_apply(params["ffn"], cfg, h, shard=ctx.shard)
        else:
            f = nl.mlp(params["ffn"], h, kind=cfg.mlp_kind, shard=ctx.shard)
        x = x + f
    return x, pool, aux
