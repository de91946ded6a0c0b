"""Mixture-of-Experts FFN, single device (port of the unsharded branch of
``repro.models.moe``).

Token-choice top-k routing with sort-based slot assignment: each expert
takes at most C = max(4, ceil(T * top_k / E * capacity_factor)) tokens,
overflow is dropped, and the (T, E, C) one-hot dispatch tensor is never
built.  Shared experts are a dense swiglu MLP added on top.  Router aux
terms (load balance, z-loss, dropped fraction) are returned beside the
output.

Two details keep it token-for-token with the JAX package: top-k breaks
ties toward the lower expert index and the slot sort is stable (both
``torch.sort(stable=True)``), and capacity depends on the number of
tokens in the call — parity holds only at drop-free capacity
(``capacity_factor = n_experts / top_k``) or for equal batch shapes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..nn import layers as nl
from ..nn.module import P
from .common import ModelConfig


def moe_defs(cfg: ModelConfig) -> Dict:
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    d: Dict = {
        "router": P((D, E), ("embed", None), init="normal", scale=0.02),
        "gate_up": P((E, D, 2, Fd), ("experts", "embed", None, "expert_mlp")),
        "down": P((E, Fd, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        d["shared"] = nl.mlp_defs(D, cfg.n_shared_experts * Fd, kind="swiglu")
    return d


def _capacity(t_local: int, cfg: ModelConfig) -> int:
    return max(4, int(math.ceil(t_local * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _moe_local(x, router_w, gate_up, down, *, cfg: ModelConfig):
    """x: (T, D) tokens. Returns (out (T, D), aux dict of f32 scalars)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    dev = x.device

    logits = (x @ router_w.to(x.dtype)).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, sel = gate_vals[:, :k], sel[:, :k]                 # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # ---- aux losses (load balance + z-loss) ---------------------------
    density = F.one_hot(sel, E).float().mean(dim=(0, 1))
    balance = E * torch.sum(density * probs.mean(dim=0)) * k
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- sort-based slot assignment ------------------------------------
    flat_e = sel.reshape(-1)                                      # (T*k,)
    flat_t = torch.arange(T * k, device=dev) // k
    flat_g = gate_vals.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - seg_start[se]
    keep = pos < C
    # dropped assignments land in a spare column C that is cut off: no
    # boolean indexing, whose size depends on the data (a host sync, and
    # no CUDA graph could capture it)
    col = torch.where(keep, pos, C)

    tok_tbl = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
    tok_tbl[se, col] = st                                         # T = pad
    tok_tbl = tok_tbl[:, :C]
    gate_tbl = torch.zeros((E, C + 1), dtype=torch.float32, device=dev)
    gate_tbl[se, col] = sg
    gate_tbl = gate_tbl[:, :C]

    x_pad = torch.cat([x, x.new_zeros((1, D))], dim=0)
    x_e = x_pad[tok_tbl]                                          # (E, C, D)
    Fd = gate_up.shape[-1]
    h = torch.bmm(x_e, gate_up.to(x.dtype).reshape(E, D, 2 * Fd))
    h = h.unflatten(-1, (2, Fd))
    h = F.silu(h[:, :, 0]) * h[:, :, 1]                           # (E, C, F)
    y_e = torch.bmm(h, down.to(x.dtype))
    y_e = y_e * gate_tbl[..., None].to(x.dtype)

    # combine: each token gathers its k expert rows (a dropped assignment
    # reads a zero row) and sums them in rank order.  A scatter-add
    # (index_add_) would sum them with atomics in no fixed order, so one
    # step's bf16 output would differ run to run, and a routing or
    # capacity decision downstream could turn that into another token.
    flat_row = torch.empty_like(order)
    flat_row[order] = torch.where(keep, se * C + pos, E * C)
    y_rows = torch.cat([y_e.reshape(E * C, D), y_e.new_zeros((1, D))])
    out = y_rows[flat_row].reshape(T, k, D).sum(dim=1)
    dropped = 1.0 - keep.float().mean()
    aux = {"balance": balance, "z_loss": z_loss, "dropped_frac": dropped}
    return out, aux


def moe_apply(params, cfg: ModelConfig, x) -> Tuple[torch.Tensor, Dict]:
    """x: (B, L, D) or (B, D).  Routed experts plus shared experts."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    out, aux = _moe_local(x2, params["router"], params["gate_up"],
                          params["down"], cfg=cfg)
    if cfg.n_shared_experts:
        out = out + nl.mlp(params["shared"], x2, kind="swiglu")
    return out.reshape(shape), aux
