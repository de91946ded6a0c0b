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


def rmsnorm(params, x, eps: float = 1e-6):
    """RMS norm with the statistics and the scale applied in f32."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


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


def embed(params, ids, compute_dtype=torch.bfloat16):
    return params["table"][ids].to(compute_dtype)


def unembed(params, x):
    """Logits projection with the (tied) embedding table."""
    return x @ params["table"].to(x.dtype).T


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


def mlp(params, x, kind: str = "swiglu"):
    if kind == "swiglu":
        wi = params["wi"].to(x.dtype)
        h = (x @ wi.reshape(wi.shape[0], -1)).unflatten(-1, wi.shape[1:])
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
        return h @ params["wo"].to(x.dtype)
    h = dense(params["wi"], x)
    h = F.gelu(h, approximate="tanh")
    return dense(params["wo"], h)


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
