"""Plain PyTorch versions of the three MLA attention kernels (port of
``repro.kernels.ref``, plus the online-softmax tile update of
``repro.kernels.mla_decode``), and the dense flash-attention oracle
:func:`flash_attention_ref`.

Each MLA function takes the kernel's inputs and returns its output:

  * ``rescale=None`` — the exact oracle: one masked softmax over the
    contiguous cache (``mla_decode_ref``) or over each request's pages
    gathered into a contiguous view (``mla_decode_paged_ref`` /
    ``mla_prefill_paged_ref``), as the JAX package's oracles do;
  * ``rescale='exp_add' | 'mul'`` — the kernel's own arithmetic: walk the
    cache in tiles (``block_k`` positions of the contiguous cache, one
    pool block of the paged one) with the online-softmax update
    :func:`softmax_tile_update` (AMLA exponent addition or the classic
    multiply), so a CPU run follows the same rounding path as the kernel.

:func:`mla_decode_split_ref` is the walk of the tensor-core decode
kernels (K1 and K3 for bf16 q): the positions cut into splits, each
walked from a fresh state, the splits merged as their combine kernel
merges them; :func:`mla_prefill_split_ref` is the same walk as bf16 K2
runs it, one decode row per (request, chunk row).

A quantized pool (int8 / fp8 codes) comes with ``ckv_scales`` /
``krope_scales`` (N, bs, 1) f32: the oracle dequantizes the gathered
view, the walk each tile it reads.  Caches are taken as they are, never
padded.

The CUDA wrappers (``mla_decode``, ``mla_prefill``) run these for CPU
tensors; ``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30
INV_LN2 = 1.4426950408889634        # log2(e): folds exp into exp2
RESCALES = ("exp_add", "mul")


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        softmax_scale: Optional[float] = None):
    """q: (B, H, Lq, Dqk); k, v: (B, Hkv, Lk, D*) -> (B, H, Lq, Dv) in q's
    dtype.  Dense reference with an f32 softmax; ``q_offset`` is the
    absolute position of q[:, :, 0] and the masks use absolute
    positions."""
    B, H, Lq, Dqk = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else Dqk ** -0.5
    qg = q.reshape(B, Hkv, H // Hkv, Lq, Dqk).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    q_pos = q_offset + torch.arange(Lq, device=q.device)[:, None]
    k_pos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Lq, v.shape[-1]).to(q.dtype)


def exp_add_rescale(x, d_i):
    """x * 2**d_i for f32 ``x`` and int32 ``d_i <= 0`` by adding d_i into
    the IEEE-754 exponent field of an int32 view (AMLA).  Zero inputs and
    exponent underflow (biased exponent reaching 0) flush to 0.0."""
    bits = x.view(torch.int32)
    exp_field = (bits >> 23) & 0xFF
    # d_i * 2**23 instead of d_i << 23: d_i is negative, and the product is
    # exact (|d_i| <= 254 keeps it inside int32)
    shifted = (bits + d_i * (1 << 23)).view(torch.float32)
    ok = (x != 0.0) & (exp_field + d_i > 0)
    return torch.where(ok, shifted, torch.zeros_like(x))


def softmax_tile_update(s, mask, ckv, acc, m, l, *, rescale: str):
    """One online-softmax + PV tile update.  ``s`` (..., R, bs) is the
    scaled f32 score tile with masked lanes already at NEG_INF, ``ckv``
    (..., bs, Dl) the f32 value tile, ``acc`` (..., R, Dl) and ``m``, ``l``
    (..., R, 1) the running state.  Returns the new (acc, m, l).

    rescale='mul'     — classic FlashAttention: real-valued running max,
      state rescaled by corr = exp(m_prev - m_new).
    rescale='exp_add' — AMLA: base-2 softmax with the running max rounded
      up to an integer, so the correction 2**d (d = m_prev - m_new, an
      integer <= 0) is an addition into the exponent bits of acc and l.
    """
    if rescale == "mul":
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ ckv
    elif rescale == "exp_add":
        s2 = s * INV_LN2
        m_new = torch.ceil(torch.maximum(m, s2.amax(dim=-1, keepdim=True)))
        p = torch.where(mask, torch.exp2(s2 - m_new), 0.0)
        # d <= 0 by construction; below -254 every f32 flushes to zero
        # anyway, and the clip keeps d * 2**23 inside int32.
        d_i = torch.clamp(m - m_new, -254.0, 0.0).to(torch.int32)
        l = exp_add_rescale(l, d_i) + p.sum(dim=-1, keepdim=True)
        acc = exp_add_rescale(acc, d_i) + p @ ckv
    else:
        raise ValueError(f"unknown rescale {rescale!r}; expected {RESCALES}")
    return acc, m_new, l


def _state(B, R, Dl, device):
    """Zeroed online-softmax state (acc, m, l) of B x R query rows."""
    return (torch.zeros((B, R, Dl), dtype=torch.float32, device=device),
            torch.full((B, R, 1), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((B, R, 1), dtype=torch.float32, device=device))


def _tile_step(q, ckv, krope, k_pos, limit, row_ok, scale, rescale, state):
    """Score one f32 tile (ckv (B, n, Dl), krope (B, n, Dr) at positions
    k_pos (n,)) with the two-term product and fold it into ``state``."""
    Dl = ckv.shape[-1]
    s = (q[..., :Dl] @ ckv.transpose(1, 2)
         + q[..., Dl:] @ krope.transpose(1, 2)) * scale
    mask = (k_pos[None, None, :] <= limit[..., None]) & row_ok[..., None]
    s = torch.where(mask, s, NEG_INF)
    return softmax_tile_update(s, mask, ckv, *state, rescale=rescale)


def _finish(state):
    acc, _, l = state
    return acc / torch.where(l == 0.0, 1.0, l)


def _pages(pages, scales, idx):
    """Pool pages ``idx`` in f32, dequantized when ``scales`` is given."""
    x = pages[idx].float()
    return x if scales is None else x * scales[idx]


def _gather(pages, scales, bt):
    """The gathered (B, nb*bs, D) view; f32 and dequantized for a
    quantized pool (the JAX package's ``_dequant_gathered``)."""
    B, nb = bt.shape
    x = pages[bt.long()].reshape(B, nb * pages.shape[1], pages.shape[-1])
    if scales is None:
        return x
    return x.float() * scales[bt.long()].reshape(B, nb * pages.shape[1], 1)


def check_scales(ckv_scales, krope_scales) -> None:
    if (ckv_scales is None) != (krope_scales is None):
        raise ValueError("pass both ckv_scales and krope_scales or neither")


def _walk(q, ckv_pages, krope_pages, bt, limit, row_ok, scale, rescale,
          ckv_scales=None, krope_scales=None):
    """Block-by-block online softmax over the pool, as the kernels do it.
    q (B, R, Dl+Dr); row r of request b attends pool positions
    <= limit[b, r] when row_ok[b, r].  Returns f32 (B, R, Dl)."""
    B, R, _ = q.shape
    bs, Dl = ckv_pages.shape[1], ckv_pages.shape[-1]
    q = q.float()
    state = _state(B, R, Dl, q.device)
    slots = torch.arange(bs, device=q.device)
    for j in range(bt.shape[1]):
        blk = bt[:, j].long()
        state = _tile_step(q, _pages(ckv_pages, ckv_scales, blk),
                           _pages(krope_pages, krope_scales, blk),
                           j * bs + slots, limit, row_ok, scale, rescale,
                           state)
    return _finish(state)


def mla_decode_ref(q_full, ckv, krope, index: int, *,
                   softmax_scale: Optional[float] = None,
                   rescale: Optional[str] = None, block_k: int = 512):
    """Contiguous-cache absorbed-MLA decode (the plain version of K3).

    q_full : (B, H, Dl+Dr) = [q_latent ; q_rope]
    ckv    : (B, S, Dl); krope: (B, S, Dr) — the split latent cache, any
             S (no padding: a ragged last tile is sliced, not padded)
    index  : host int — newest valid position, shared by the batch
             (attend to positions <= index)
    Returns (B, H, Dl) in q_full's dtype.

    ``rescale=None`` is the exact oracle (the JAX package's
    ``mla_decode_ref``); otherwise the kernel's walk over ``block_k``
    positions a tile, tiles past ``index`` skipped, so a negative index
    yields zero rows as the kernels give them."""
    B, H, D = q_full.shape
    S, Dl = ckv.shape[1], ckv.shape[2]
    index = int(index)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    pos = torch.arange(S, device=q_full.device)
    if rescale is None:
        cache = torch.cat([ckv, krope], dim=-1).float()
        s = torch.einsum("bhd,bsd->bhs", q_full.float(), cache) * scale
        s = torch.where(pos <= index, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bsk->bhk", p, ckv.float())
        return o.to(q_full.dtype)
    q = q_full.float()
    state = _state(B, H, Dl, q.device)
    limit = torch.full((B, H), index, device=q.device)
    ok = torch.ones((B, H), dtype=torch.bool, device=q.device)
    for j0 in range(0, min(index + 1, S), block_k):
        j1 = min(j0 + block_k, S)
        state = _tile_step(q, ckv[:, j0:j1].float(), krope[:, j0:j1].float(),
                           pos[j0:j1], limit, ok, scale, rescale, state)
    return _finish(state).to(q_full.dtype)


def merge_splits(parts, rescale: str):
    """Merge the states (acc, m, l) of splits of the positions, as the
    combine kernel does: a split with l = 0 saw no position and is left
    out (its acc is never read); the others are rescaled to the largest
    m, by exp_add_rescale (every m is an integer under 'exp_add', so the
    factor is an exact power of two) or by exp(m - M) ('mul').  Returns
    acc / l in f32."""
    acc = torch.stack([a for a, _, _ in parts])
    m = torch.stack([m for _, m, _ in parts])
    l = torch.stack([l for _, _, l in parts])
    live = l > 0.0
    top = torch.where(live, m, NEG_INF).amax(dim=0)
    if rescale == "exp_add":
        d_i = torch.clamp(m - top, -254.0, 0.0).to(torch.int32)
        acc = torch.where(live, exp_add_rescale(acc, d_i), 0.0).sum(dim=0)
        l = torch.where(live, exp_add_rescale(l, d_i), 0.0).sum(dim=0)
    elif rescale == "mul":
        corr = torch.exp(m - top)
        acc = torch.where(live, acc * corr, 0.0).sum(dim=0)
        l = torch.where(live, l * corr, 0.0).sum(dim=0)
    else:
        raise ValueError(f"unknown rescale {rescale!r}; expected {RESCALES}")
    return acc / torch.where(l == 0.0, 1.0, l)


def mla_decode_split_ref(q_full, ckv, krope, indices, *, split_pos: int,
                         tile: int = 64, softmax_scale: Optional[float] = None,
                         rescale: str = "exp_add", block_tables=None,
                         ckv_scales=None, krope_scales=None):
    """The split walk of the tensor-core decode kernels, in f32.

    Contiguous (K3): ckv (B, S, Dl), krope (B, S, Dr), ``indices`` the
    host int index.  Paged (K1): ckv / krope are the pool's pages
    (N, bs, .) read through ``block_tables`` (B, nb), ``indices`` (B,)
    int32, with (N, bs, 1) f32 scales for a quantized pool.

    Positions [s * split_pos, (s + 1) * split_pos) form split s
    (``split_pos`` a multiple of ``tile``, as ``_launch.split_plan``
    makes it); each split is walked from a fresh state in tiles of
    ``tile`` positions, positions past a request's index masked, and the
    splits are merged by :func:`merge_splits`.  A split that starts past
    a request's index (or every split, for an index of -1) contributes
    nothing.  Returns (B, H, Dl) in q_full's dtype."""
    if split_pos <= 0 or split_pos % tile:
        raise ValueError(f"split_pos {split_pos} must be a positive "
                         f"multiple of the tile {tile}")
    B, H, D = q_full.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if block_tables is not None:
        check_scales(ckv_scales, krope_scales)
        ckv = _gather(ckv, ckv_scales, block_tables)
        krope = _gather(krope, krope_scales, block_tables)
        limit = indices.to(torch.long)
    else:
        limit = torch.full((B,), int(indices), dtype=torch.long,
                           device=q_full.device)
    R, Dl = ckv.shape[1], ckv.shape[-1]
    last = int(limit.max())
    q = q_full.float()
    pos = torch.arange(R, device=q.device)
    lim = limit[:, None].expand(B, H)
    ok = torch.ones((B, H), dtype=torch.bool, device=q.device)
    parts = []
    for s0 in range(0, max(R, 1), split_pos):
        state = _state(B, H, Dl, q.device)
        for j0 in range(s0, min(s0 + split_pos, R, last + 1), tile):
            j1 = min(j0 + tile, s0 + split_pos, R)
            state = _tile_step(q, ckv[:, j0:j1].float(),
                               krope[:, j0:j1].float(), pos[j0:j1], lim, ok,
                               scale, rescale, state)
        parts.append(state)
    return merge_splits(parts, rescale).to(q_full.dtype)


def mla_prefill_split_ref(q_full, ckv_pages, krope_pages, block_tables,
                          lengths, n_valid, *, split_pos: int,
                          tile: int = 64,
                          softmax_scale: Optional[float] = None,
                          rescale: str = "exp_add", ckv_scales=None,
                          krope_scales=None):
    """The split walk of bf16 K2 (paged chunked prefill), in f32: chunk
    row c of request b is the paged decode row of
    :func:`mla_decode_split_ref` over positions <= lengths[b] + c through
    b's block-table row, or a zero row when c >= n_valid[b].  Arguments
    as :func:`mla_prefill_paged_ref`, plus ``split_pos`` and ``tile`` as
    for the decode walk.  Returns (B, C, H, Dl) in q_full's dtype."""
    B, C, H, D = q_full.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    c = torch.arange(C, dtype=torch.int32, device=q_full.device)
    index = torch.where(c[None, :] < n_valid[:, None].to(torch.int32),
                        lengths[:, None].to(torch.int32) + c[None, :], -1)
    o = mla_decode_split_ref(
        q_full.reshape(B * C, H, D), ckv_pages, krope_pages,
        index.reshape(B * C), split_pos=split_pos, tile=tile,
        softmax_scale=scale, rescale=rescale,
        block_tables=block_tables.repeat_interleave(C, dim=0),
        ckv_scales=ckv_scales, krope_scales=krope_scales)
    return o.reshape(B, C, H, -1)


def mla_decode_paged_ref(q_full, ckv_pages, krope_pages, block_tables,
                         indices, *, softmax_scale: Optional[float] = None,
                         rescale: Optional[str] = None, ckv_scales=None,
                         krope_scales=None):
    """Paged absorbed-MLA decode.

    q_full      : (B, H, Dl+Dr)
    ckv_pages   : (N, bs, Dl); krope_pages: (N, bs, Dr) — global block pool
    block_tables: (B, nb) int32 — request-local block j -> pool block
    indices     : (B,) int32 — newest valid position per request (attend to
                  pos <= indices[b]; a negative index yields a zero row).
    ckv_scales, krope_scales: (N, bs, 1) f32 for a quantized pool.
    Returns (B, H, Dl) in q_full's dtype.
    """
    B, H, D = q_full.shape
    nb, bs = block_tables.shape[1], ckv_pages.shape[1]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if rescale is not None:
        limit = indices[:, None].expand(B, H)
        ok = torch.ones((B, H), dtype=torch.bool, device=q_full.device)
        return _walk(q_full, ckv_pages, krope_pages, block_tables, limit, ok,
                     scale, rescale, ckv_scales,
                     krope_scales).to(q_full.dtype)
    ckv = _gather(ckv_pages, ckv_scales, block_tables)
    krope = _gather(krope_pages, krope_scales, block_tables)
    cache = torch.cat([ckv, krope], dim=-1).float()
    s = torch.einsum("bhd,bsd->bhs", q_full.float(), cache) * scale
    valid = torch.arange(nb * bs, device=q_full.device)[None, :] \
        <= indices[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.where(valid[:, None, :], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bhs,bsk->bhk", p, ckv.float())
    return o.to(q_full.dtype)


def mla_prefill_paged_ref(q_full, ckv_pages, krope_pages, block_tables,
                          lengths, n_valid, *,
                          softmax_scale: Optional[float] = None,
                          rescale: Optional[str] = None, ckv_scales=None,
                          krope_scales=None):
    """Paged chunked-prefill attention (multi-query sibling of
    :func:`mla_decode_paged_ref`).

    q_full      : (B, C, H, Dl+Dr) — chunk queries in the joint latent space
    ckv_pages   : (N, bs, Dl); krope_pages: (N, bs, Dr) — global pool (the
                  chunk's own latents are already written in)
    block_tables: (B, nb) int32; lengths: (B,) int32 — absolute position of
                  each row's first chunk token; n_valid: (B,) int32 — real
                  tokens per row (rows past it, and idle rows with n_valid
                  0, yield EXACT ZEROS).
    ckv_scales, krope_scales: (N, bs, 1) f32 for a quantized pool.
    Chunk token c attends pool positions <= lengths[b] + c.
    Returns (B, C, H, Dl) in q_full's dtype.
    """
    B, C, H, D = q_full.shape
    nb, bs = block_tables.shape[1], ckv_pages.shape[1]
    Dl = ckv_pages.shape[-1]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    c = torch.arange(C, dtype=lengths.dtype, device=q_full.device)
    q_pos = lengths[:, None] + c[None, :]                           # (B, C)
    row_ok = c[None, :] < n_valid[:, None]                          # (B, C)
    if rescale is not None:
        limit = q_pos[:, :, None].expand(B, C, H).reshape(B, C * H)
        ok = row_ok[:, :, None].expand(B, C, H).reshape(B, C * H)
        o = _walk(q_full.reshape(B, C * H, D), ckv_pages, krope_pages,
                  block_tables, limit, ok, scale, rescale, ckv_scales,
                  krope_scales)
        return o.reshape(B, C, H, Dl).to(q_full.dtype)
    ckv = _gather(ckv_pages, ckv_scales, block_tables)
    krope = _gather(krope_pages, krope_scales, block_tables)
    cache = torch.cat([ckv, krope], dim=-1).float()
    s = torch.einsum("bchd,bsd->bchs", q_full.float(), cache) * scale
    k_pos = torch.arange(nb * bs, device=q_full.device)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) & row_ok[:, :, None]
    s = torch.where(valid[:, :, None, :], s, NEG_INF)
    p = torch.where(valid[:, :, None, :], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bchs,bsk->bchk", p, ckv.float())
    return o.to(q_full.dtype)
