"""Sublayer bodies: (pre-norm mixer) + (pre-norm FFN), dispatched on the
``Sub`` descriptor (port of the MLA modes of ``repro.models.blocks``).

    sub_defs(cfg, desc, d_ff)                -> param defs
    sub_apply(params, cfg, desc, x, ctx)     -> (x, cache, aux)
    sub_cache(cfg, desc, batch, capacity, ...)    this sublayer's
                                                  contiguous latent cache
    sub_paged_cache(cfg, desc, ..., device)  -> this sublayer's paged pool

Only MLA attention with a dense or MoE FFN is ported, in the modes
'train' and 'prefill' (MHA-mode MLA over the whole sequence, attention
dense with ``impl='ref'`` or in the flash-attention kernels with
``impl='kernel'``; 'prefill' also returns a contiguous latent cache),
'decode' (contiguous when ``ctx.lengths`` is None, else paged) and
'prefill_chunk' (paged); other mixers and modes raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core import cache as cachelib
from ..core import mla as mlalib
from ..kernels import ops as kops
from ..nn import layers as nl
from . import moe as moelib
from .common import ModelConfig, Sub

MODES = ("decode", "prefill_chunk", "prefill", "train")
# engine/model ``impl`` -> the attention path of core.mla
_MLA_IMPL = {"ref": "gather", "kernel": "kernel"}


@dataclasses.dataclass
class Ctx:
    mode: str                       # decode | prefill_chunk | prefill | train
    impl: str = "ref"               # attention impl: 'ref' | 'kernel'
    scheme: str = "seq"             # MLA execution scheme
    positions: Any = None           # (B, L) int — train / prefill
    cache: Optional[Dict] = None    # this sublayer's cache or paged pool
    index: int = 0                  # contiguous decode: tokens cached
    capacity: int = 0               # prefill: S of the returned cache
    block_tables: Any = None        # (B, max_blocks) int32 — paged
    lengths: Any = None             # (B,) int32 — paged, ragged
    n_valid: Any = None             # (B,) int32 — chunked prefill only


def _supported(cfg: ModelConfig, desc: Sub) -> None:
    if desc.mixer != "attn" or cfg.attn_kind != "mla":
        raise NotImplementedError(
            f"the port serves MLA attention sublayers only, got "
            f"mixer={desc.mixer!r} attn_kind={cfg.attn_kind!r} "
            f"(other families: ROADMAP.md)")


def sub_defs(cfg: ModelConfig, desc: Sub, d_ff: Optional[int] = None) -> Dict:
    _supported(cfg, desc)
    d: Dict = {"ln1": nl.rmsnorm_defs(cfg.d_model),
               "attn": mlalib.mla_defs(cfg.mla_config())}
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
    """Contiguous decode state of one sublayer: its (B, S) latent cache."""
    _supported(cfg, desc)
    return cachelib.latent_cache(batch, capacity, cfg.kv_lora_rank,
                                 cfg.qk_rope_dim, dtype, device)


def sub_paged_cache(cfg: ModelConfig, desc: Sub, num_blocks: int,
                    block_size: int, dtype=torch.bfloat16, device="cuda",
                    cache_dtype: Optional[str] = None) -> Dict:
    """Paged decode state of one sublayer: its latent block pool
    (quantized with scale leaves for ``cache_dtype`` 'int8' / 'fp8')."""
    _supported(cfg, desc)
    return cachelib.paged_latent_cache(num_blocks, block_size,
                                       cfg.kv_lora_rank, cfg.qk_rope_dim,
                                       dtype, device, cache_dtype)


AUX_KEYS = ("balance", "z_loss", "dropped_frac")


def _mla_seq(params, cfg: ModelConfig, desc: Sub, x, ctx: Ctx):
    """Train / prefill forward of one MLA sublayer over the whole sequence.
    x: (B, L, D) normalized input.  Returns (out, cache): in 'prefill'
    mode a contiguous latent cache of ``ctx.capacity`` (or L) positions
    holding the L entries, else None."""
    attn_fn = None
    if ctx.impl == "kernel":
        def attn_fn(q, k, v, softmax_scale):
            return kops.attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                impl="kernel", causal=desc.causal, window=desc.window,
                softmax_scale=softmax_scale).transpose(1, 2)
    elif ctx.impl != "ref":
        raise NotImplementedError(
            f"{ctx.mode} impl {ctx.impl!r}: the port runs 'ref' or "
            f"'kernel'; 'chunked' comes with core/chunked_attention.py "
            f"(ROADMAP.md queue 1, item 17)")
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


def sub_apply(params, cfg: ModelConfig, desc: Sub, x, ctx: Ctx):
    """x: (B, D) for decode, (B, C, D) for prefill_chunk, (B, L, D) for
    train and prefill.  Returns (x, cache, aux) — aux holds f32 scalars
    (zeros without a router); cache is the new contiguous cache in
    prefill mode, the updated cache or pool in the decode modes, None in
    train mode."""
    _supported(cfg, desc)
    if ctx.mode not in MODES:
        raise NotImplementedError(
            f"mode {ctx.mode!r}: the port runs {MODES} only (ROADMAP.md)")
    h = nl.rmsnorm(params["ln1"], x, cfg.norm_eps)
    pool = ctx.cache
    if ctx.mode in ("train", "prefill"):
        a, pool = _mla_seq(params["attn"], cfg, desc, h, ctx)
    elif ctx.mode == "decode" and ctx.lengths is None:
        a, pool = mlalib.mla_decode(
            params["attn"], cfg.mla_config(), h, ctx.cache, ctx.index,
            scheme=ctx.scheme, impl=_MLA_IMPL[ctx.impl])
    elif ctx.mode == "decode":
        a, pool = mlalib.mla_decode_paged(
            params["attn"], cfg.mla_config(), h, ctx.cache,
            ctx.block_tables, ctx.lengths, scheme=ctx.scheme,
            impl=_MLA_IMPL[ctx.impl])
    else:
        a, pool = mlalib.mla_prefill_chunk_paged(
            params["attn"], cfg.mla_config(), h, ctx.cache,
            ctx.block_tables, ctx.lengths, ctx.n_valid, scheme=ctx.scheme,
            impl=_MLA_IMPL[ctx.impl])
    x = x + a

    aux = {k: x.new_zeros((), dtype=torch.float32) for k in AUX_KEYS}
    if desc.ffn != "none":
        h = nl.rmsnorm(params["ln2"], x, cfg.norm_eps)
        if desc.ffn == "moe":
            f, aux = moelib.moe_apply(params["ffn"], cfg, h)
        else:
            f = nl.mlp(params["ffn"], h, kind=cfg.mlp_kind)
        x = x + f
    return x, pool, aux
