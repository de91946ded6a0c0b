"""Base layers: dense, RMS and layer norms, embedding, RoPE, MLPs, the
causal depthwise conv of Mamba (port of ``repro.nn.layers``).

Every layer is a (defs, apply) pair of plain functions; params are the
nested dicts produced by ``module.init_params``.  Layouts are the JAX
package's (e.g. the swiglu ``wi`` is (d, 2, f), gate first), so one
parameter tree serves both packages.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import collectives as coll
from .module import P

# ---------------------------------------------------------------- dense ----


def dense_defs(in_dim: int, out_dim: int, in_ax: Optional[str], out_ax: Optional[str],
               bias: bool = False, init: str = "fan_in", scale: Optional[float] = None):
    d = {"w": P((in_dim, out_dim), (in_ax, out_ax), init=init, scale=scale)}
    if bias:
        d["b"] = P((out_dim,), (out_ax,), init="zeros")
    return d


def dense(params, x, compute_dtype=None):
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ----------------------------------------------------------------- norms ---


def rmsnorm_defs(dim: int, ax: Optional[str] = None):
    return {"scale": P((dim,), (ax,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6, cols: Optional[int] = None):
    """RMS norm with the statistics and the scale applied in f32.  With
    ``cols``, the columns cols .. cols + len(scale) - 1 of the normed
    rows (the statistics are the whole row's): a rank's part of a
    sharded dim, ``params`` holding its part of the scale."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if cols is not None:
        x = x[..., cols:cols + scale.shape[0]]
    return (x * scale).to(dtype)


def layernorm_defs(dim: int, ax: Optional[str] = None):
    return {"scale": P((dim,), (ax,), init="ones"),
            "bias": P((dim,), (ax,), init="zeros")}


def layernorm(params, x, eps: float = 1e-5):
    """Layer norm with the statistics, the scale and the bias in f32."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dtype)


# ------------------------------------------------------------- embedding ---


def embed_defs(vocab: int, dim: int):
    return {"table": P((vocab, dim), ("vocab", "embed"), init="embed", scale=0.02)}


def embed(params, ids, compute_dtype=torch.bfloat16, shard=None):
    """Rows of the table for ``ids``.  Under a mesh whose rules split the
    vocab over 'model' (``shard``, an ``nn.sharding.Shard``), each rank
    holds a slice of the vocab: it looks up the ids in its slice, leaves
    zeros for the others, and the rows are summed over 'model' (exact:
    each row comes from one rank)."""
    table = params["table"]
    if shard is None or not shard.splits("vocab"):
        return table[ids].to(compute_dtype)
    n = table.shape[0]
    local = ids - shard.part("vocab", n)
    mine = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)].to(compute_dtype)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype))
    return shard.reduce(x, "vocab")


def unembed(params, x, shard=None):
    """Logits projection with the (tied) embedding table.  Under a mesh
    (``shard``) x holds this DP shard's rows: the logits are gathered
    over 'model' (the vocab, where the rules split it) and over 'data'
    (the rows) in one collective, and every rank gets the whole batch's
    full rows."""
    logits = x @ params["table"].to(x.dtype).T
    if shard is None:
        return logits
    dims = {"data": 0, "model": -1} if shard.splits("vocab") \
        else {"data": 0}
    return coll.all_gather_blocks(logits, shard.mesh, dims)


# ------------------------------------------------------------------ RoPE ---


def rope_angles(positions, dim: int, base: float):
    """positions: (..., L) int -> cos, sin of shape (..., L, dim//2) f32."""
    half = dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                            device=positions.device) / half))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (B, L, H, D) or (B, L, D); positions: (B, L). Rotate-half (NeoX),
    computed in f32."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, base)
    if x.dim() == 4:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLPs ---


def mlp_defs(d_model: int, d_ff: int, kind: str = "swiglu", bias: bool = False):
    if kind == "swiglu":
        return {
            "wi": P((d_model, 2, d_ff), ("embed", None, "mlp")),  # [gate; up] fused
            "wo": P((d_ff, d_model), ("mlp", "embed")),
        }
    return {"wi": dense_defs(d_model, d_ff, "embed", "mlp", bias=bias),
            "wo": dense_defs(d_ff, d_model, "mlp", "embed", bias=bias)}


def mlp(params, x, kind: str = "swiglu", shard=None):
    """Under a mesh (``shard``) whose rules split the hidden dim ('mlp')
    over 'model', ``wi`` is column- and ``wo`` row-parallel: the partial
    outputs are summed before ``wo``'s bias is added.  Where they put it
    on 'data' as well ('serve_2dtp'), the weights stay resident: every DP
    shard's rows are gathered, each rank runs its part of the hidden dim
    on all of them, the sum runs over both axes and each rank keeps its
    own rows."""
    wide = shard is not None and shard.spans("mlp")
    if wide:
        x = shard.gather_rows(x)
    bias = None
    if kind == "swiglu":
        wi = params["wi"].to(x.dtype)
        h = (x @ wi.reshape(wi.shape[0], -1)).unflatten(-1, wi.shape[1:])
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
        y = h @ params["wo"].to(x.dtype)
    else:
        h = F.gelu(dense(params["wi"], x), approximate="tanh")
        if shard is None:
            return dense(params["wo"], h)
        y, bias = h @ params["wo"]["w"], params["wo"].get("b")
    if shard is not None:
        y = shard.reduce(y, "mlp")
    if wide:
        y = shard.local_rows(y)
    return y if bias is None else y + bias.to(y.dtype)


# -------------------------------------------------- causal depthwise conv ---


def causal_conv1d_defs(channels: int, width: int):
    return {"w": P((width, channels), (None, "mlp"), init="fan_in"),
            "b": P((channels,), ("mlp",), init="zeros")}


def causal_conv1d(params, x):
    """x: (B, L, C) -> (B, L, C), causal depthwise conv in x's dtype: the
    taps are added one by one, oldest first, as the reference does."""
    w, b = params["w"], params["b"]
    width, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for k in range(width):
        out = out + w[k].to(x.dtype) * pad[:, k:k + L]
    return out + b.to(x.dtype)


def causal_conv1d_step(params, x_t, conv_state):
    """One decode step.  x_t: (B, C); conv_state: (B, width - 1, C), the
    last inputs.  The window's f32 products are summed oldest first, each
    add a fused multiply-add (one rounding a tap), as the reference's
    einsum accumulates; the sum rounds to x_t's dtype.  Returns (out (B,
    C), the new conv state)."""
    w, b = params["w"], params["b"]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, W, C)
    out = window[:, 0].float() * w[0].float()
    for k in range(1, w.shape[0]):
        # an f32 x f32 product is exact in f64: the add rounds once
        out = (out.double() + window[:, k].double() * w[k].double()).float()
    return out.to(x_t.dtype) + b.to(x_t.dtype), window[:, 1:, :]
