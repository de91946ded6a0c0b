"""Standard GQA attention, the dense reference path of MHA-mode MLA
(port of ``repro.core.attention.gqa_attention``; the other functions of
that module come with the non-MLA families, ROADMAP.md)."""
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
