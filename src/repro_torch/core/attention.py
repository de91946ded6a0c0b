"""Standard MHA / GQA / MQA attention — the paper's baseline family
(MHA_l / MHA_s) and the dense reference path of MHA-mode MLA (port of
``repro.core.attention``).

Plain PyTorch, as the reference is plain ``jnp``: the models swap in the
flash-attention kernel K4 for the prefill / train path; one-token decode
(``gqa_decode``) stays here.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ref import NEG_INF


def gqa_attention(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_positions=None,
                  k_positions=None, softmax_scale: Optional[float] = None):
    """q: (B, Lq, H, Dh); k, v: (B, Lk, Hkv, Dh), H % Hkv == 0 ->
    (B, Lq, H, Dv) in q's dtype.  Native-dtype operands, f32 products and
    softmax (the reference's ``preferred_element_type=f32``)."""
    B, Lq, H, Dh = q.shape
    Hkv = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Lq, Hkv, H // Hkv, Dh)
    scores = torch.einsum("blhgd,bshd->bhgls", qg.to(k.dtype).float(),
                          k.float()) * scale
    if causal or window is not None:
        q_pos = q_positions if q_positions is not None else torch.arange(
            Lq, device=q.device)
        k_pos = k_positions if k_positions is not None else torch.arange(
            k.shape[1], device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgls,bshd->blhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Lq, H, v.shape[-1]).to(q.dtype)


def gqa_decode(q, k_cache, v_cache, index: int, *,
               window: Optional[int] = None,
               softmax_scale: Optional[float] = None):
    """One-token decode.  q: (B, H, Dh); caches (B, S, Hkv, Dh) already
    holding the new token at ``index`` (a host int).  Position p is
    attended when p <= index and, with a window, p > index - window.
    Native-dtype operands, f32 products and softmax.  Returns (B, H, Dv)
    in q's dtype."""
    B, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.to(k_cache.dtype).float(),
                          k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = pos <= index
    if window is not None:
        valid &= pos > index - window
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)
