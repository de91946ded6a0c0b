"""Memory-bounded attention in plain PyTorch (port of
``repro.core.chunked_attention``): the ``'chunked'`` train / prefill
attention impl.

No (Lq, Lk) tensor is ever held.  ``chunked_attention`` walks the q
blocks, each against the full key width (live scores (B, block_q, H,
Lk)); ``chunked_attention_pairs`` walks only the (q-block, k-block)
pairs inside the mask's support with an online softmax across them (the
flash-attention grid as a host loop), so causal and windowed attention
skip the blocks the mask removes.

Each is a ``torch.autograd.Function`` whose backward recomputes the
probabilities from the saved log-sum-exp, as the reference's
``custom_vjp``s do: autograd keeps only (q, k, v, out, lse), not the
per-block probability tensors.

Layouts match the model stack: q (B, Lq, H, Dqk); k, v (B, Lk, Hkv, D*),
H a multiple of Hkv (GQA as (B, bq, Hkv, G, D)).  Operands keep their
dtype until the products, which run in f32 (the reference's
``preferred_element_type=f32``); the probabilities are rounded to v's
dtype before the PV product, as there.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -2.0 ** 30


def _f32(x, dtype):
    """x rounded to ``dtype`` and taken to f32 for the products."""
    return x.to(dtype).float()


def _pad_len(x, n: int):
    """Zero-pad dim 1 of x by n positions."""
    if not n:
        return x
    return F.pad(x, (0,) * (2 * (x.dim() - 2)) + (0, n))


def _mask(q_pos, k_pos, causal: bool, window: Optional[int], lk_valid: int):
    """(bq, bk) bool: key k_pos visible from query q_pos."""
    m = (k_pos[None, :] < lk_valid).expand(q_pos.shape[0], -1)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


# ------------------------------------------------------- q-block scan ----


def _fwd_block(qb, k, v, q_pos, *, scale, causal, window, lk_valid):
    """qb (B, bq, Hkv, G, D); k, v (B, Lk, Hkv, D*) -> (out f32, lse)."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", _f32(qb, k.dtype), k.float()) \
        * scale
    k_pos = torch.arange(k.shape[1], device=k.device)
    mask = _mask(q_pos, k_pos, causal, window, lk_valid)[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l_sum = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bqhgk,bkhd->bqhgd", _f32(p, v.dtype), v.float()) \
        / l_sum
    return out, (m + torch.log(l_sum))[..., 0]


class _Chunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, block_q):
        B, Lq, H, Dqk = q.shape
        Hkv = k.shape[2]
        G = H // Hkv
        bq = min(block_q, Lq)
        qp = _pad_len(q, -Lq % bq)
        outs, lses = [], []
        for i in range(qp.shape[1] // bq):
            qb = qp[:, i * bq:(i + 1) * bq].reshape(B, bq, Hkv, G, Dqk)
            q_pos = q_offset + i * bq + torch.arange(bq, device=q.device)
            o, lse = _fwd_block(qb, k, v, q_pos, scale=scale, causal=causal,
                                window=window, lk_valid=k.shape[1])
            outs.append(o)
            lses.append(lse)
        out = torch.cat(outs, 1).reshape(B, -1, H, v.shape[-1])[:, :Lq] \
            .to(q.dtype)
        lse = torch.cat(lses, 1)[:, :Lq]                  # (B, Lq, Hkv, G)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, scale, bq)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, scale, bq = ctx.args
        B, Lq, H, Dqk = q.shape
        Lk, Hkv = k.shape[1], k.shape[2]
        G, Dv = H // Hkv, v.shape[-1]
        pad = -Lq % bq
        qp, dop, op = (_pad_len(t, pad) for t in (q, dout, out))
        lsep = _pad_len(lse, pad)
        k_pos = torch.arange(Lk, device=q.device)
        cdt = k.dtype
        kf, vf = k.float(), v.float()
        dk = torch.zeros((B, Lk, Hkv, Dqk), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros((B, Lk, Hkv, Dv), dtype=torch.float32,
                         device=q.device)
        dqs = []
        for i in range(qp.shape[1] // bq):
            rows = slice(i * bq, (i + 1) * bq)
            qb = qp[:, rows].reshape(B, bq, Hkv, G, Dqk)
            dob = dop[:, rows].reshape(B, bq, Hkv, G, Dv)
            ob = op[:, rows].reshape(B, bq, Hkv, G, Dv)
            q_pos = q_offset + i * bq + torch.arange(bq, device=q.device)
            s = torch.einsum("bqhgd,bkhd->bqhgk", _f32(qb, cdt), kf) * scale
            mask = _mask(q_pos, k_pos, causal, window, Lk)[:, None, None, :]
            p = torch.where(mask, torch.exp(s - lsep[:, rows, ..., None]),
                            0.0)
            delta = (dob.float() * ob.float()).sum(dim=-1, keepdim=True)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", _f32(dob, cdt), vf)
            ds = p * (dp - delta) * scale
            dsf = _f32(ds, cdt)
            dqs.append(torch.einsum("bqhgk,bkhd->bqhgd", dsf, kf))
            dk += torch.einsum("bqhgk,bqhgd->bkhd", dsf, _f32(qb, cdt))
            dv += torch.einsum("bqhgk,bqhgd->bkhd", _f32(p, cdt),
                               _f32(dob, cdt))
        dq = torch.cat(dqs, 1).reshape(B, -1, H, Dqk)[:, :Lq]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def chunked_attention(q, k, v, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      softmax_scale: Optional[float] = None,
                      block_q: int = 256):
    """q (B, Lq, H, Dqk); k, v (B, Lk, Hkv, D) -> (B, Lq, H, Dv) in q's
    dtype.  Query i sits at position ``q_offset + i``; every key is
    valid."""
    scale = softmax_scale if softmax_scale is not None else \
        q.shape[-1] ** -0.5
    return _Chunked.apply(q, k, v, causal, window, q_offset, scale, block_q)


# ----------------------------------------------------- block-pair walk ---


def _pair_list(nq: int, nk: int, bq: int, bk: int, q_offset: int,
               causal: bool, window: Optional[int],
               lk_valid: int) -> List[Tuple[int, int]]:
    """The (i, j) block pairs that intersect the mask's support."""
    pairs = []
    for i in range(nq):
        q_lo, q_hi = q_offset + i * bq, q_offset + (i + 1) * bq - 1
        for j in range(nk):
            k_lo, k_hi = j * bk, (j + 1) * bk - 1
            if k_lo >= lk_valid:
                continue
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi <= q_lo - window:
                continue
            pairs.append((i, j))
    return pairs


def _pair_mask(i, j, bq, bk, q_offset, causal, window, lk_valid, device):
    q_pos = q_offset + i * bq + torch.arange(bq, device=device)
    k_pos = j * bk + torch.arange(bk, device=device)
    return _mask(q_pos, k_pos, causal, window, lk_valid)[:, None, None, :]


class _Pairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, block_q,
                block_k):
        B, Lq, H, Dqk = q.shape
        Lk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
        G = H // Hkv
        bq, bk = min(block_q, Lq), min(block_k, Lk)
        qp = _pad_len(q, -Lq % bq)
        kp, vp = _pad_len(k, -Lk % bk), _pad_len(v, -Lk % bk)
        Lqp = qp.shape[1]
        pairs = _pair_list(Lqp // bq, kp.shape[1] // bk, bq, bk, q_offset,
                           causal, window, Lk)
        cdt = k.dtype
        m_st = torch.full((B, Lqp, Hkv, G), NEG_INF, dtype=torch.float32,
                          device=q.device)
        l_st = torch.zeros((B, Lqp, Hkv, G), dtype=torch.float32,
                           device=q.device)
        acc = torch.zeros((B, Lqp, Hkv, G, Dv), dtype=torch.float32,
                          device=q.device)
        for i, j in pairs:
            rows, keys = slice(i * bq, (i + 1) * bq), slice(j * bk,
                                                          (j + 1) * bk)
            qb = qp[:, rows].reshape(B, bq, Hkv, G, Dqk)
            s = torch.einsum("bqhgd,bkhd->bqhgk", _f32(qb, cdt),
                             kp[:, keys].float()) * scale
            mask = _pair_mask(i, j, bq, bk, q_offset, causal, window, Lk,
                              q.device)
            s = torch.where(mask, s, NEG_INF)
            m_rows = m_st[:, rows]
            m_new = torch.clamp(torch.maximum(m_rows, s.amax(dim=-1)),
                                min=NEG_INF / 2)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_rows - m_new)
            l_st[:, rows] = l_st[:, rows] * corr + p.sum(dim=-1)
            acc[:, rows] = acc[:, rows] * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", _f32(p, cdt), vp[:, keys].float())
            m_st[:, rows] = m_new
        l_safe = torch.clamp(l_st, min=1e-30)
        out = (acc / l_safe[..., None]).reshape(B, Lqp, H, Dv)[:, :Lq] \
            .to(q.dtype)
        lse = (m_st + torch.log(l_safe)).reshape(B, Lqp, H)[:, :Lq]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, scale, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, scale, bq, bk = ctx.args
        B, Lq, H, Dqk = q.shape
        Lk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
        G = H // Hkv
        pad_q = -Lq % bq
        qp, dop, lsep = (_pad_len(t, pad_q) for t in (q, dout, lse))
        kp, vp = _pad_len(k, -Lk % bk), _pad_len(v, -Lk % bk)
        Lqp, Lkp = qp.shape[1], kp.shape[1]
        delta = (dop.float() * _pad_len(out, pad_q).float()).sum(dim=-1)
        pairs = _pair_list(Lqp // bq, Lkp // bk, bq, bk, q_offset, causal,
                           window, Lk)
        cdt = k.dtype
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros((B, Lqp, Hkv, G, Dqk), **f32)
        dk = torch.zeros((B, Lkp, Hkv, Dqk), **f32)
        dv = torch.zeros((B, Lkp, Hkv, Dv), **f32)
        for i, j in pairs:
            rows, keys = slice(i * bq, (i + 1) * bq), slice(j * bk,
                                                          (j + 1) * bk)
            qb = _f32(qp[:, rows].reshape(B, bq, Hkv, G, Dqk), cdt)
            dob = _f32(dop[:, rows].reshape(B, bq, Hkv, G, Dv), cdt)
            kb, vb = kp[:, keys].float(), vp[:, keys].float()
            lseb = lsep[:, rows].reshape(B, bq, Hkv, G)
            dlb = delta[:, rows].reshape(B, bq, Hkv, G)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb) * scale
            mask = _pair_mask(i, j, bq, bk, q_offset, causal, window, Lk,
                              q.device)
            p = torch.where(mask, torch.exp(s - lseb[..., None]), 0.0)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", dob, vb)
            dsf = _f32(p * (dp - dlb[..., None]) * scale, cdt)
            dq[:, rows] += torch.einsum("bqhgk,bkhd->bqhgd", dsf, kb)
            dk[:, keys] += torch.einsum("bqhgk,bqhgd->bkhd", dsf, qb)
            dv[:, keys] += torch.einsum("bqhgk,bqhgd->bkhd", _f32(p, cdt),
                                        dob)
        return (dq.reshape(B, Lqp, H, Dqk)[:, :Lq].to(q.dtype),
                dk[:, :Lk].to(k.dtype), dv[:, :Lk].to(v.dtype),
                None, None, None, None, None, None)


def chunked_attention_pairs(q, k, v, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0,
                            softmax_scale: Optional[float] = None,
                            block_q: int = 256, block_k: int = 256):
    """Mask-aware block-pair attention, the contract of
    :func:`chunked_attention`.  Work scales with the mask's support:
    ~(nq + 1) / (2 nq) of the full square for causal, ~(window + bq) / Lk
    for a sliding window."""
    scale = softmax_scale if softmax_scale is not None else \
        q.shape[-1] ** -0.5
    return _Pairs.apply(q, k, v, causal, window, q_offset, scale, block_q,
                        block_k)
