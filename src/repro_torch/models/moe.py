"""Mixture-of-Experts FFN (port of ``repro.models.moe``), on one device
or with expert parallelism (EP) over a mesh's 'model' axis.

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

Under a mesh (``shard``, an ``nn.sharding.Shard``) the reference's mesh
form is copied: every rank routes its tokens over all E experts (the
router is replicated) and runs only its own slice of experts; the
combine below fills the rows of the other ranks' experts with zeros and
sums the (T, k, D) rows over 'model' before the rank-order sum over k,
so each row comes from one rank and the expert part is bit for bit one
device's.  The tokens are this DP shard's and each DP shard counts its
OWN capacity, ``_capacity(T_local)`` — so below drop-free capacity a
mesh drops other tokens than one device does, as the reference's mesh
engine does.  (The reference counts the global batch when it does not
divide over the DP shards; the port's sharded steps refuse such a batch,
and its engine pads ``max_batch`` to a DP multiple.)  Under
'serve_2dtp', as in the reference, the tokens are replicated instead
(the DP shards' rows are gathered; capacity counts the whole batch) and
the expert bank is 2D-sharded and resident: experts over 'model', each
expert's hidden dim over 'data'.  Each rank runs its experts' part of
the hidden dim, the rows are summed over both axes (the reference's
psum over (model, data): an activation-sized reduction in the place of
a per-step weight all-gather), and each rank keeps its rows of the
output.  There a row is the sum of the data ranks' partial products,
so the expert part agrees with one device's to rounding, not bit for
bit.  The shared experts' hidden dim splits over 'model' like a dense
FFN's (``nn.layers.mlp``).
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


def _moe_local(x, router_w, gate_up, down, *, cfg: ModelConfig,
               first: int = 0, reduce=None):
    """x: (T, D) tokens; ``gate_up`` / ``down`` the experts ``first`` ..
    ``first + len(gate_up) - 1`` (all of them on one device), whole or
    this rank's part of their hidden dim.  ``reduce`` sums the gathered
    (T, k, D) expert rows over the ranks that hold the other experts and
    the other parts of the hidden dim.  Returns (out (T, D), aux dict of
    f32 scalars)."""
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

    E_loc = gate_up.shape[0]
    tok_tbl = tok_tbl[first:first + E_loc]
    gate_tbl = gate_tbl[first:first + E_loc]
    x_pad = torch.cat([x, x.new_zeros((1, D))], dim=0)
    x_e = x_pad[tok_tbl]                                      # (E_loc, C, D)
    Fd = gate_up.shape[-1]
    h = torch.bmm(x_e, gate_up.to(x.dtype).reshape(E_loc, D, 2 * Fd))
    h = h.unflatten(-1, (2, Fd))
    h = F.silu(h[:, :, 0]) * h[:, :, 1]                       # (E_loc, C, F)
    y_e = torch.bmm(h, down.to(x.dtype))
    y_e = y_e * gate_tbl[..., None].to(x.dtype)

    # combine: each token gathers its k expert rows (a dropped assignment
    # reads a zero row) and sums them in rank order.  A scatter-add
    # (index_add_) would sum them with atomics in no fixed order, so one
    # step's bf16 output would differ run to run, and a routing or
    # capacity decision downstream could turn that into another token.
    # Under EP the other ranks' experts read zero rows here, and the sum
    # over 'model' fills them: each row is one rank's (under 'serve_2dtp'
    # the sum over 'data' also adds the parts of the hidden dim).
    flat_row = torch.empty_like(order)
    flat_row[order] = torch.where(keep, se * C + pos, E * C)
    y_rows = y_e.new_zeros((E * C + 1, D))
    y_rows[first * C:(first + E_loc) * C] = y_e.reshape(E_loc * C, D)
    rows = y_rows[flat_row].reshape(T, k, D)
    if reduce is not None:
        rows = reduce(rows)
    out = rows.sum(dim=1)
    dropped = 1.0 - keep.float().mean()
    aux = {"balance": balance, "z_loss": z_loss, "dropped_frac": dropped}
    return out, aux


def moe_apply(params, cfg: ModelConfig, x, shard=None
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, L, D) or (B, D) — under a mesh (``shard``), this DP shard's
    rows, and ``params`` this rank's (experts split over 'model' where
    the rules say so).  Routed experts plus shared experts."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if shard is None:
        out, aux = _moe_local(x2, params["router"], params["gate_up"],
                              params["down"], cfg=cfg)
    else:
        replicated = shard.policy == "serve_2dtp"
        xs = shard.gather_rows(x2) if replicated else x2
        first = shard.part("experts", params["gate_up"].shape[0])
        out, aux = _moe_local(xs, params["router"], params["gate_up"],
                              params["down"], cfg=cfg, first=first,
                              reduce=lambda r: shard.reduce(r, "experts",
                                                            "expert_mlp"))
        if replicated:
            out = shard.local_rows(out)
    if cfg.n_shared_experts:
        out = out + nl.mlp(params["shared"], x2, kind="swiglu", shard=shard)
    return out.reshape(shape), aux
