"""Multi-Head Latent Attention with the paper's execution schemes
selectable per call (port of ``repro.core.mla``: the contiguous and the
paged serving paths and the MHA-mode prefill).

Decode score chain (paper notation, per head):

    z = q_l . W_up^Q . W_up^{K,T} . C^T          (+ decoupled RoPE path)

  'naive'  up-project the gathered latent cache to K/V and run MHA (the
           paper's strawman; a numerics oracle);
  'seq'    q_l -> (W_up^Q) -> q -> (W_up^{K,T}) -> latent space;
  'rc'     recompute W_absorb = W_up^Q @ W_up^{K,T} every step;
  'ru'     stream the precomputed W_absorb (``attach_absorbed_tree``).

All schemes compute the same function with the same weights.
:func:`mla_prefill` is the training and contiguous-prefill forward ("MHA
mode": K and V are up-projected per head and attended densely, or in the
flash-attention kernels through ``attn_fn``).  :func:`mla_decode` attends
one contiguous latent cache per request, densely (the reference) or in
kernel K3 (``impl='kernel'``).  The paged attention runs either on the
gathered (B, S) block-table view (``impl='gather'``, the reference) or
in the paged CUDA kernels, which walk the block table in place
(``impl='kernel'``), passing a quantized pool's scales along.  Every
kernel runs its plain blockwise version for CPU tensors.  Products of native-dtype operands that the
JAX package accumulates in f32 (``preferred_element_type``) are taken in
f32 here too, on an f32 copy of the operands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..kernels import ops as kops
from ..kernels.ref import NEG_INF
from ..nn import collectives as coll
from ..nn import layers as nl
from ..nn.module import P
from . import cache as cachelib
from .attention import gqa_attention

SCHEMES = ("naive", "seq", "rc", "ru")
IMPLS = ("gather", "kernel")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_base: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def cache_dims(self) -> Tuple[int, int]:
        return self.kv_lora_rank, self.qk_rope_dim


def param_count(cfg: MLAConfig, rope: bool = True) -> int:
    """Closed-form #params of one MLA layer (paper Table 1 when rope=False)."""
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, (cfg.qk_rope_dim if rope else 0), cfg.v_head_dim
    return (cfg.d_model * cfg.q_lora_rank
            + cfg.q_lora_rank * H * (dn + dr)
            + cfg.d_model * (cfg.kv_lora_rank + dr)
            + cfg.kv_lora_rank * H * (dn + dv)
            + H * dv * cfg.d_model)


def mla_defs(cfg: MLAConfig) -> Dict[str, Any]:
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": P((cfg.d_model, cfg.q_lora_rank), ("embed", "q_lora")),
        "q_norm": nl.rmsnorm_defs(cfg.q_lora_rank, "q_lora"),
        "w_uq": P((cfg.q_lora_rank, H, dn + dr), ("q_lora", "heads", None)),
        "w_dkv": P((cfg.d_model, cfg.kv_lora_rank + dr), ("embed", None)),
        "kv_norm": nl.rmsnorm_defs(cfg.kv_lora_rank, "kv_lora"),
        "w_uk": P((cfg.kv_lora_rank, H, dn), ("kv_lora", "heads", None)),
        "w_uv": P((cfg.kv_lora_rank, H, dv), ("kv_lora", "heads", None)),
        "w_o": P((H, dv, cfg.d_model), ("heads", None, "embed")),
    }


def absorb_qk(params: Dict[str, Any], cfg: MLAConfig):
    """W_absorb = W_up^Q(nope) @ W_up^{K,T} : (H, D_ql, D_kvl), in f32."""
    w_uq_nope = params["w_uq"][:, :, : cfg.qk_nope_dim]
    return torch.einsum("qhn,khn->hqk", w_uq_nope.float(),
                        params["w_uk"].float())


def attach_absorbed_tree(params, cfg: MLAConfig):
    """Return a copy of a model param tree with the precomputed W_absorb
    (absorbed in f32, then cast to the weights' dtype) attached on every
    MLA sublayer.  'ru' streams it; the other schemes ignore it."""
    if isinstance(params, dict):
        if "w_uq" in params and "w_uk" in params:
            absorb = absorb_qk(params, cfg).to(params["w_uq"].dtype)
            return {**params, "w_absorb": absorb}
        return {k: attach_absorbed_tree(v, cfg) for k, v in params.items()}
    if isinstance(params, list):
        return [attach_absorbed_tree(v, cfg) for v in params]
    return params


# ------------------------------------------------------------- projections -


def _q_proj(params, cfg: MLAConfig, x, positions, shard=None):
    """x: (B, L, D) -> q_l (B,L,Q), q_nope (B,L,H,dn), q_rope (B,L,H,dr).

    Under a mesh whose rules put the q lora dim on 'data' ('serve_2dtp':
    ``w_dq``, ``q_norm`` and ``w_uq`` hold this data rank's part of it,
    resident) the lora dim is contracted in place: every DP shard's rows
    are gathered, the down-projection's columns are gathered over 'data'
    for the norm, and ``w_uq``'s partial products are summed over
    'data'.  q_l is then this rank's columns of the whole batch's rows
    (what :func:`_q_latent` contracts); q_nope / q_rope this DP shard's
    rows."""
    if shard is None or not shard.spans("q_lora"):
        q_l = nl.rmsnorm(params["q_norm"], x @ params["w_dq"].to(x.dtype))
        q = torch.einsum("blq,qhd->blhd", q_l, params["w_uq"].to(x.dtype))
    else:
        c = coll.all_gather(shard.gather_rows(x) @ params["w_dq"].to(x.dtype),
                            shard.mesh, "data", -1)
        n = params["q_norm"]["scale"].shape[0]
        q_l = nl.rmsnorm(params["q_norm"], c,
                         cols=shard.mesh.index("data") * n)
        q = _lora_sum(shard, "blq,qhd->blhd", q_l,
                      params["w_uq"].to(x.dtype))
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = nl.apply_rope(q_rope, positions, cfg.rope_base)
    return q_l, q_nope, q_rope


def _lora_sum(shard, eq: str, q_l, w):
    """einsum(eq, q_l, w) over this rank's part of the q lora dim (q_l
    holds every DP shard's rows), summed over 'data' and cut to this DP
    shard's rows."""
    return shard.local_rows(shard.reduce(torch.einsum(eq, q_l, w), "q_lora"))


def _kv_latent(params, cfg: MLAConfig, x, positions):
    """x: (B, L, D) -> ckv (B,L,Dkvl) normalized, krope (B,L,dr) rotated."""
    c = x @ params["w_dkv"].to(x.dtype)
    ckv = nl.rmsnorm(params["kv_norm"], c[..., : cfg.kv_lora_rank])
    krope = nl.apply_rope(c[..., cfg.kv_lora_rank:], positions, cfg.rope_base)
    return ckv, krope


def _absorbed(params, cfg: MLAConfig, dtype):
    """'rc': W_absorb recomputed in f32 from the factors, cast to dtype."""
    return absorb_qk(params, cfg).to(dtype)


def _absorbed_q(params, cfg: MLAConfig, q_l, scheme: str, eq: str,
                shard=None):
    """'rc' / 'ru': q_l times W_absorb (recomputed from the factors, or
    the attached one).  Under a mesh that puts the q lora dim on 'data'
    (see :func:`_q_proj`), this rank's part of the lora dim, summed over
    'data'."""
    if scheme == "rc":
        w = _absorbed(params, cfg, q_l.dtype)
    elif scheme == "ru":
        w = params["w_absorb"].to(q_l.dtype)
    else:
        raise ValueError(f"unknown scheme {scheme}")
    if shard is None or not shard.spans("q_lora"):
        return torch.einsum(eq, q_l, w)
    if scheme == "ru":      # attached whole over the lora dim
        n = q_l.shape[-1]
        w = w.narrow(1, shard.mesh.index("data") * n, n)
    return _lora_sum(shard, eq, q_l, w)


def _q_latent(params, cfg: MLAConfig, q_l, q_nope, scheme: str, shard=None):
    """Map the nope-query into the KV-latent space per execution scheme.
    q_l (B, Q), q_nope (B, H, dn) -> q_eff (B, H, D_kvl)."""
    if scheme == "seq":
        return torch.einsum("bhn,khn->bhk", q_nope,
                            params["w_uk"].to(q_nope.dtype))
    return _absorbed_q(params, cfg, q_l, scheme, "bq,hqk->bhk", shard)


def _q_latent_chunk(params, cfg: MLAConfig, q_l, q_nope, scheme: str,
                    shard=None):
    """Chunk-shaped sibling of :func:`_q_latent`: q_l (B, C, Q), q_nope
    (B, C, H, dn) -> q_eff (B, C, H, D_kvl)."""
    if scheme == "seq":
        return torch.einsum("bchn,khn->bchk", q_nope,
                            params["w_uk"].to(q_nope.dtype))
    return _absorbed_q(params, cfg, q_l, scheme, "bcq,hqk->bchk", shard)


def _f32_product(eq: str, a, b):
    """Native-dtype operands, f32 accumulation and result (the JAX
    package's ``preferred_element_type=f32``)."""
    return torch.einsum(eq, a.float(), b.float())


def _scales(pool) -> Dict[str, Any]:
    """A quantized pool's per-slot scales, as the kernels take them; the
    kernels dequantize in registers, so the pool is never dequantized."""
    if not cachelib.is_quantized_pool(pool):
        return {}
    return {"ckv_scales": pool["ckv_scale"],
            "krope_scales": pool["krope_scale"]}


def _check(scheme: str, impl: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected {SCHEMES}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected {IMPLS}")


# ----------------------------------------------------------------- prefill -


def mla_prefill(params, cfg: MLAConfig, x, positions, *, attn_fn=None,
                return_cache: bool = False):
    """Training / prefill forward in MHA mode: up-project the latents to
    per-head K and V and attend in the full space.

    x: (B, L, D); positions (B, L).  ``attn_fn(q, k, v, softmax_scale)``
    takes (B, L, H, D) tensors and returns (B, L, H, Dv); None runs the
    dense :func:`gqa_attention`.  Returns (out (B, L, D), {ckv, krope} if
    ``return_cache`` else None).
    """
    _, q_nope, q_rope = _q_proj(params, cfg, x, positions)
    ckv, krope = _kv_latent(params, cfg, x, positions)
    k_nope = torch.einsum("blk,khn->blhn", ckv, params["w_uk"].to(x.dtype))
    v = torch.einsum("blk,khv->blhv", ckv, params["w_uv"].to(x.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
    scale = cfg.qk_dim ** -0.5
    if attn_fn is None:
        o = gqa_attention(q, k, v, causal=True, q_positions=positions[0],
                          k_positions=positions[0], softmax_scale=scale)
    else:
        o = attn_fn(q, k, v, softmax_scale=scale)
    out = torch.einsum("blhv,hvd->bld", o, params["w_o"].to(x.dtype))
    entries = {"ckv": ckv, "krope": krope} if return_cache else None
    return out, entries


def _sharded_rows(shard, block_table, lengths, n_valid=None):
    """This DP shard's rows of the batch-wide tables (all of them without
    a mesh)."""
    if shard is None:
        return block_table, lengths, n_valid
    return (shard.local_rows(block_table), shard.local_rows(lengths),
            None if n_valid is None else shard.local_rows(n_valid))


def _gather_latents(shard, ckv_new, krope_new):
    """The new latent rows of the whole batch: every model rank computes
    the same rows of its DP shard (the latent path is replicated), and
    the DP shards' rows are gathered, so every rank writes every row, in
    one order, and the pool replicas stay bitwise equal."""
    if shard is None:
        return ckv_new, krope_new
    return shard.gather_rows(ckv_new, krope_new)


def _out_proj(o, w_o, eq: str, shard):
    """The row-parallel output projection: this rank's heads' part,
    summed over 'model' where the heads are split."""
    out = torch.einsum(eq, o, w_o)
    return out if shard is None else shard.reduce(out, "heads")


def mla_prefill_chunk_paged(params, cfg: MLAConfig, x, pool: Dict[str, Any],
                            block_table, lengths, n_valid, *,
                            scheme: str = "seq", impl: str = "gather",
                            shard=None):
    """One CHUNK of batched prefill, directly into the paged pool.

    x: (B, C, D) — row b carries the next ``n_valid[b]`` prompt tokens of
    its request, starting at absolute position ``lengths[b]``.  Rows with
    ``n_valid[b] == 0`` are idle padding (garbage out; their latents go to
    the null block).  The chunk's latents are written into the pool first
    (in place), then the queries attend the resident prefix through the
    block table.  Returns (out (B, C, D), pool).

    ``impl``: 'gather' materializes the contiguous (B, S) block-table view
    (the reference); 'kernel' runs the paged prefill kernel, which walks
    the block table in place.  'naive' has no kernel path and always takes
    the gathered view.

    Under a mesh (``shard``, an ``nn.sharding.Shard``): x holds this DP
    shard's rows and ``params`` this rank's heads (the q up-projection,
    ``w_uk`` / ``w_uv`` and ``w_absorb`` column-parallel, ``w_o``
    row-parallel, its output summed over 'model'); block_table, lengths
    and n_valid are the whole batch's.  The latent path is replicated:
    the new rows of every DP shard are gathered and written by every
    rank into its replica of the pool.
    """
    _check(scheme, impl)
    tables, all_lengths, all_valid = block_table, lengths, n_valid
    block_table, lengths, n_valid = _sharded_rows(shard, block_table,
                                                  lengths, n_valid)
    C = x.shape[1]
    pos = lengths[:, None] + torch.arange(C, dtype=lengths.dtype,
                                          device=x.device)[None, :]
    q_l, q_nope, q_rope = _q_proj(params, cfg, x, pos, shard)
    ckv_new, krope_new = _kv_latent(params, cfg, x, pos)
    pool = cachelib.update_latent_paged_chunk(
        pool, tables, all_lengths, all_valid,
        *_gather_latents(shard, ckv_new, krope_new))
    scale = cfg.qk_dim ** -0.5
    w_uv = params["w_uv"].to(x.dtype)
    w_o = params["w_o"].to(x.dtype)

    if impl == "kernel" and scheme != "naive":
        q_eff = _q_latent_chunk(params, cfg, q_l, q_nope, scheme, shard)
        q_full = torch.cat([q_eff, q_rope], dim=-1).contiguous()
        o_lat = kops.mla_prefill_paged_attention(
            q_full, pool["ckv"], pool["krope"], block_table, lengths,
            n_valid, impl="kernel", softmax_scale=scale, **_scales(pool))
        o = torch.einsum("bchk,khv->bchv", o_lat.to(x.dtype), w_uv)
        return _out_proj(o, w_o, "bchv,hvd->bcd", shard), pool

    ckv_c, krope_c = cachelib.gather_latent_paged(pool, block_table)
    S = ckv_c.shape[1]
    s_pos = torch.arange(S, dtype=lengths.dtype, device=x.device)
    valid = (s_pos[None, None, :] <= pos[:, :, None]) \
        & (s_pos[None, None, :] < (lengths + n_valid)[:, None, None])
    if scheme == "naive":
        k_nope = torch.einsum("bsk,khn->bshn", ckv_c,
                              params["w_uk"].to(ckv_c.dtype))
        v_full = torch.einsum("bsk,khv->bshv", ckv_c,
                              params["w_uv"].to(ckv_c.dtype))
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, krope_c[:, :, None, :].to(k_nope.dtype)
                       .expand(*k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
        scores = _f32_product("bchd,bshd->bchs", q.to(k.dtype), k) * scale
        scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        o = _f32_product("bchs,bshv->bchv", p.to(v_full.dtype),
                         v_full).to(x.dtype)
    else:
        q_eff = _q_latent_chunk(params, cfg, q_l, q_nope, scheme, shard)
        scores = (_f32_product("bchk,bsk->bchs", q_eff.to(ckv_c.dtype), ckv_c)
                  + _f32_product("bchr,bsr->bchs", q_rope.to(krope_c.dtype),
                                 krope_c)) * scale
        scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        o_lat = _f32_product("bchs,bsk->bchk", p.to(ckv_c.dtype),
                             ckv_c).to(x.dtype)
        o = torch.einsum("bchk,khv->bchv", o_lat, w_uv)
    return _out_proj(o, w_o, "bchv,hvd->bcd", shard), pool


# ------------------------------------------------------------------ decode -


def _naive_scores(params, cfg: MLAConfig, q_nope, q_rope, ckv_c, krope_c,
                  scale):
    """'naive' (1->3->2): up-project the whole cache to per-head K and V
    (the paper's strawman).  Returns f32 scores (B, H, S) and V."""
    k_nope = torch.einsum("bsk,khn->bshn", ckv_c,
                          params["w_uk"].to(ckv_c.dtype))
    v_full = torch.einsum("bsk,khv->bshv", ckv_c,
                          params["w_uv"].to(ckv_c.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope_c[:, :, None, :].to(k_nope.dtype)
                   .expand(*k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
    return _f32_product("bhd,bshd->bhs", q.to(k.dtype), k) * scale, v_full


def mla_decode(params, cfg: MLAConfig, x_t, cache: Dict[str, Any],
               index: int, *, scheme: str = "seq", impl: str = "gather"):
    """One-token decode over a contiguous latent cache.

    x_t: (B, D); cache: {ckv (B, S, Dl), krope (B, S, Dr)}; ``index`` a
    host int — tokens already cached, shared by the batch.  The new token
    is written at ``index`` (in place), then attends positions <= index.
    Returns (out (B, D), cache).

    ``impl``: 'kernel' runs the latent attention of 'seq' / 'rc' / 'ru'
    in kernel K3; 'gather' (the reference: here no gather is needed)
    attends the whole cache with one masked softmax.  'naive' always
    up-projects the cache and has no kernel path.
    """
    _check(scheme, impl)
    B = x_t.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.long, device=x_t.device)
    x = x_t[:, None, :]
    q_l, q_nope, q_rope = _q_proj(params, cfg, x, pos)
    q_l, q_nope, q_rope = q_l[:, 0], q_nope[:, 0], q_rope[:, 0]
    ckv_new, krope_new = _kv_latent(params, cfg, x, pos)
    cache = cachelib.update_latent(cache, ckv_new, krope_new, index)
    ckv_c, krope_c = cache["ckv"], cache["krope"]
    S = ckv_c.shape[1]
    scale = cfg.qk_dim ** -0.5
    w_uv = params["w_uv"].to(x_t.dtype)
    w_o = params["w_o"].to(x_t.dtype)
    valid = torch.arange(S, device=x_t.device) <= index

    if scheme == "naive":
        scores, v_full = _naive_scores(params, cfg, q_nope, q_rope, ckv_c,
                                       krope_c, scale)
        p = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        o = _f32_product("bhs,bshv->bhv", p.to(v_full.dtype),
                         v_full).to(x_t.dtype)
        return torch.einsum("bhv,hvd->bd", o, w_o), cache

    q_eff = _q_latent(params, cfg, q_l, q_nope, scheme)
    if impl == "kernel":
        q_full = torch.cat([q_eff, q_rope], dim=-1).contiguous()
        o_lat = kops.mla_decode_attention(q_full, ckv_c, krope_c, index,
                                          impl="kernel", softmax_scale=scale)
    else:
        scores = (_f32_product("bhk,bsk->bhs", q_eff.to(ckv_c.dtype), ckv_c)
                  + _f32_product("bhr,bsr->bhs", q_rope.to(krope_c.dtype),
                                 krope_c)) * scale
        p = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        o_lat = _f32_product("bhs,bsk->bhk", p.to(ckv_c.dtype),
                             ckv_c).to(x_t.dtype)
    o = torch.einsum("bhk,khv->bhv", o_lat, w_uv)
    return torch.einsum("bhv,hvd->bd", o, w_o), cache


def mla_decode_paged(params, cfg: MLAConfig, x_t, pool: Dict[str, Any],
                     block_table, lengths, *, scheme: str = "seq",
                     impl: str = "gather", shard=None):
    """One continuous-batching decode step over the paged latent pool.

    x_t: (B, D) — one token per batch slot; pool: {ckv (N,bs,Dl), krope
    (N,bs,Dr)}, block 0 = null; block_table (B, nb) int32; lengths (B,)
    int32 — tokens already cached per slot (ragged).  The new token is
    written at position lengths[b] (in place), then each request attends
    its own 0..lengths[b] prefix.  Inactive slots (length 0, null table)
    produce garbage the runtime discards.  Returns (out (B, D), pool).

    ``impl``: 'gather' (the reference view) or 'kernel' (the paged decode
    kernel); 'naive' always takes the gathered view.  A quantized pool is
    written quantized; the kernel gets its scales, the gathered view is
    dequantized.  Under a mesh (``shard``) as
    :func:`mla_prefill_chunk_paged`.
    """
    _check(scheme, impl)
    tables, all_lengths = block_table, lengths
    block_table, lengths, _ = _sharded_rows(shard, block_table, lengths)
    pos = lengths[:, None]
    x = x_t[:, None, :]
    q_l, q_nope, q_rope = _q_proj(params, cfg, x, pos, shard)
    q_l, q_nope, q_rope = q_l[:, 0], q_nope[:, 0], q_rope[:, 0]
    ckv_new, krope_new = _kv_latent(params, cfg, x, pos)
    pool = cachelib.update_latent_paged(
        pool, tables, all_lengths,
        *_gather_latents(shard, ckv_new[:, 0], krope_new[:, 0]))
    scale = cfg.qk_dim ** -0.5
    w_uv = params["w_uv"].to(x_t.dtype)
    w_o = params["w_o"].to(x_t.dtype)

    if impl == "kernel" and scheme != "naive":
        q_eff = _q_latent(params, cfg, q_l, q_nope, scheme, shard)
        q_full = torch.cat([q_eff, q_rope], dim=-1).contiguous()
        o_lat = kops.mla_decode_paged_attention(
            q_full, pool["ckv"], pool["krope"], block_table, lengths,
            impl="kernel", softmax_scale=scale, **_scales(pool))
        o = torch.einsum("bhk,khv->bhv", o_lat, w_uv)
        return _out_proj(o, w_o, "bhv,hvd->bd", shard), pool

    ckv_c, krope_c = cachelib.gather_latent_paged(pool, block_table)
    S = ckv_c.shape[1]
    valid = cachelib.paged_valid_mask(S, lengths)[:, None]   # (B, 1, S)
    if scheme == "naive":
        scores, v_full = _naive_scores(params, cfg, q_nope, q_rope, ckv_c,
                                       krope_c, scale)
        scores = torch.where(valid, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        o = _f32_product("bhs,bshv->bhv", p.to(v_full.dtype),
                         v_full).to(x_t.dtype)
    else:
        q_eff = _q_latent(params, cfg, q_l, q_nope, scheme, shard)
        scores = (_f32_product("bhk,bsk->bhs", q_eff.to(ckv_c.dtype), ckv_c)
                  + _f32_product("bhr,bsr->bhs", q_rope.to(krope_c.dtype),
                                 krope_c)) * scale
        scores = torch.where(valid, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        o_lat = _f32_product("bhs,bsk->bhk", p.to(ckv_c.dtype),
                             ckv_c).to(x_t.dtype)
        o = torch.einsum("bhk,khv->bhv", o_lat, w_uv)
    return _out_proj(o, w_o, "bhv,hvd->bd", shard), pool
