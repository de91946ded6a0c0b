"""Mamba-1 selective SSM mixer, Jamba's sequence layer (port of
``repro.models.mamba``).

The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t (diagonal A) is
evaluated in chunks of CHUNK positions: inside a chunk a log-step
(Hillis-Steele) inclusive scan under the reference's combine (a1, b1),
(a2, b2) -> (a2 a1, a2 b1 + b2), across chunks a host loop carrying the
(B, d_inner, N) f32 state.  The scan multiplies decays and never takes
an exp of a cumulative log-decay: at init A = -e and dt ~ 0.7, so the
log-decay falls by ~1.9 a position, far past f32's exp range over a
chunk.

Memory: the (B, c, d_inner, N) f32 working set exists for one chunk at a
time and, where it would pass SCAN_SLICE_BYTES, for one slice of d_inner
at a time (at Jamba's full width a whole chunk of batch 8 is 2.15 GB a
tensor).  The scan is elementwise in d_inner, so slicing moves a value
only through the summation order of the products around it.  Under
``cfg.remat`` each (chunk, slice) step runs under
``torch.utils.checkpoint``: the backward recomputes it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import cache as cachelib
from ..nn import layers as nl
from ..nn.module import P
from .common import ModelConfig, chunk_len

CHUNK = 256
# the largest (B, c, d_inner slice, N) f32 tensor of one scan step
SCAN_SLICE_BYTES = 1 << 28


def mamba_defs(cfg: ModelConfig) -> Dict:
    D, dI, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    return {
        "in_proj": P((D, 2, dI), ("embed", None, "mlp")),
        "conv": nl.causal_conv1d_defs(dI, cfg.conv_width),
        "x_proj": P((dI, R + 2 * N), ("mlp", None)),
        "dt_proj": P((R, dI), (None, "mlp")),
        "dt_bias": P((dI,), ("mlp",), init="zeros"),
        "A_log": P((dI, N), ("mlp", None), init="ones"),
        "D": P((dI,), ("mlp",), init="ones"),
        "out_proj": P((dI, D), ("mlp", "embed")),
    }


def _softplus(x):
    """The reference's ``jax.nn.softplus``: log(1 + e^x) = logaddexp(x,
    0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_params(params, cfg: ModelConfig, x_c):
    """x_c: (..., dI) post-conv activations -> dt, B, C (f32)."""
    R, N = cfg.dt_rank, cfg.d_state
    proj = (x_c @ params["x_proj"].to(x_c.dtype)).float()
    dt_low, Bs, Cs = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = _softplus(dt_low @ params["dt_proj"].float()
                   + params["dt_bias"].float())
    return dt, Bs, Cs


def _scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) under the combine
    (a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2), in log2(c) steps."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def _chunk_step(h0, dt, Bs, Cs, x, A):
    """One chunk of one d_inner slice: h0 (B, d, N); dt, x (B, c, d); Bs,
    Cs (B, c, N); A (d, N).  Returns (state at the chunk's end, y (B, c,
    d))."""
    dA = torch.exp(dt[..., None] * A)                        # (B, c, d, N)
    dBx = (dt * x)[..., None] * Bs[:, :, None, :]
    a, b = _scan(dA, dBx)
    h = a * h0[:, None] + b
    return h[:, -1], torch.einsum("bcdn,bcn->bcd", h, Cs)


def _chunked_ssm(dt, Bs, Cs, x_c, A, *, remat: bool):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, h_0
    = 0.  dt (B, L, dI) f32, Bs / Cs (B, L, N) f32, x_c (B, L, dI), A
    (dI, N).  Returns (y (B, L, dI) f32, the last state (B, dI, N))."""
    B, L, dI = x_c.shape
    N = A.shape[-1]
    c = chunk_len(L, CHUNK)
    width = max(1, min(dI, SCAN_SLICE_BYTES // (B * c * N * 4)))
    x32 = x_c.float()
    h = dt.new_zeros((B, dI, N))
    ys = []
    for t0 in range(0, L, c):
        t = slice(t0, t0 + c)
        hs, y = [], []
        for d0 in range(0, dI, width):
            d = slice(d0, d0 + width)
            args = (h[:, d], dt[:, t, d], Bs[:, t], Cs[:, t], x32[:, t, d],
                    A[d])
            h_d, y_d = checkpoint(_chunk_step, *args, use_reentrant=False) \
                if remat else _chunk_step(*args)
            hs.append(h_d)
            y.append(y_d)
        h = torch.cat(hs, dim=1)
        ys.append(torch.cat(y, dim=-1))
    return torch.cat(ys, dim=1), h


def mamba_forward(params, cfg: ModelConfig, x, *,
                  return_state: bool = False):
    """x: (B, L, D) -> ((B, L, D), the decode state after the L positions
    if ``return_state`` else None)."""
    L = x.shape[1]
    w_in = params["in_proj"].to(x.dtype)
    xz = (x @ w_in.reshape(w_in.shape[0], -1)).unflatten(-1, w_in.shape[1:])
    x_in, z = xz[:, :, 0], xz[:, :, 1]
    x_c = F.silu(nl.causal_conv1d(params["conv"], x_in))
    dt, Bs, Cs = _ssm_params(params, cfg, x_c)
    A = -torch.exp(params["A_log"].float())                     # (dI, N)
    y, h_last = _chunked_ssm(dt, Bs, Cs, x_c, A, remat=cfg.remat)
    y = y + params["D"].float() * x_c.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"].to(x.dtype)
    if not return_state:
        return out, None
    W = cfg.conv_width
    # a copy: a view would keep the whole (B, L, 2, dI) projection alive
    conv_state = x_in[:, -(W - 1):].clone() if L >= W - 1 else \
        F.pad(x_in, (0, 0, W - 1 - L, 0))
    return out, {"conv": conv_state, "ssm": h_last}


def mamba_step(params, cfg: ModelConfig, x_t, state) -> Tuple[torch.Tensor,
                                                               Dict]:
    """One decode step.  x_t: (B, D); state {'conv': (B, W - 1, dI),
    'ssm': (B, dI, N) f32}.  Returns (out (B, D), the new state); the
    state given is not changed."""
    w_in = params["in_proj"].to(x_t.dtype)
    xz = (x_t @ w_in.reshape(w_in.shape[0], -1)).unflatten(-1,
                                                           w_in.shape[1:])
    x_in, z = xz[:, 0], xz[:, 1]
    x_c, conv_state = nl.causal_conv1d_step(params["conv"], x_in,
                                            state["conv"])
    x_c = F.silu(x_c)
    dt, Bs, Cs = _ssm_params(params, cfg, x_c)
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt[..., None] * A)                           # (B, dI, N)
    dBx = (dt * x_c.float())[..., None] * Bs[:, None, :]
    h = dA * state["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cs)
    y = y + params["D"].float() * x_c.float()
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return y @ params["out_proj"].to(x_t.dtype), {"conv": conv_state,
                                                  "ssm": h}


def mamba_state_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict:
    return cachelib.mamba_state(batch, cfg.d_inner, cfg.d_state,
                                cfg.conv_width, dtype, device)
