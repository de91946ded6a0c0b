"""xLSTM mixers (port of ``repro.models.xlstm``): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, a strictly sequential
loop).

mLSTM:  C_t = f_t C_{t-1} + i_t v_t k_t^T,  y_t = (q_t C_t) / max(|q_t
n_t|, 1), evaluated chunk by chunk: inside a chunk the decay-weighted
matrix P[t, s] = exp(F_t - F_s) i_s (q_t . k_s) (F the cumulative
log-decay) is dense; C and the normalizer n carry across chunks in a host
loop.  The reference's simplifications are kept: a sigmoid input gate
for mLSTM; sLSTM with exponential gating and the m-stabilizer but full
(not block-diagonal) recurrent weights.

The intra-chunk weights take ``exp`` over the whole (c, c) square and
only then mask the upper triangle, as the reference does
(``xlstm.py:84``): at 128 positions a chunk the upper entries overflow,
and the backward gets 0 * inf (ROADMAP.md queue 3).  The order is kept
for parity; its fix belongs to both packages at once.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..nn.module import P
from .common import ModelConfig, chunk_len

CHUNK = 128


def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out), in x's dtype."""
    w = w.to(x.dtype)
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


# ------------------------------------------------------------- mLSTM -------


def mlstm_defs(cfg: ModelConfig) -> Dict:
    D, dI, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = dI // H
    return {
        "up": P((D, 2, dI), ("embed", None, "mlp")),
        "qkv": P((dI, H, 3, dh), ("mlp", None, None, None)),
        "gates": P((dI, H, 2), ("mlp", None, None), init="normal",
                   scale=0.02),
        "gate_bias": P((H, 2), (None, None), init="zeros"),
        "out": P((dI, D), ("mlp", "embed")),
    }


def _mlstm_qkvif(params, cfg: ModelConfig, x_m):
    """x_m: (..., dI) -> q, k, v (..., H, dh) f32; log_f, i (..., H)
    f32."""
    dh = cfg.d_inner // cfg.n_heads
    qkv = _proj(x_m, params["qkv"])
    q, k, v = (qkv[..., 0, :].float(), qkv[..., 1, :].float() * dh ** -0.5,
               qkv[..., 2, :].float())
    g = _proj(x_m, params["gates"]).float() + params["gate_bias"].float()
    return q, k, v, F.logsigmoid(g[..., 0]), torch.sigmoid(g[..., 1])


def mlstm_forward(params, cfg: ModelConfig, x, *,
                  return_state: bool = False):
    """x: (B, L, D) -> ((B, L, D), {'C', 'n'} after the L positions if
    ``return_state`` else None)."""
    B, L, _ = x.shape
    H = cfg.n_heads
    dh = cfg.d_inner // H
    up = _proj(x, params["up"])
    x_m, z = up[:, :, 0], up[:, :, 1]
    q, k, v, log_f, i_g = _mlstm_qkvif(params, cfg, x_m)
    c = chunk_len(L, CHUNK)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    C0 = x.new_zeros((B, H, dh, dh), dtype=torch.float32)
    n0 = x.new_zeros((B, H, dh), dtype=torch.float32)
    ys = []
    for t0 in range(0, L, c):
        t = slice(t0, t0 + c)
        q_, k_, v_, ig = q[:, t], k[:, t], v[:, t], i_g[:, t]
        Fc = torch.cumsum(log_f[:, t], dim=1)          # (B, c, H)
        # across chunks: y_t += exp(F_t) q_t C0, denom += exp(F_t) q_t n0
        qF = q_ * torch.exp(Fc)[..., None]
        cross = torch.einsum("bchd,bhde->bche", qF, C0)
        cross_n = torch.einsum("bchd,bhd->bch", qF, n0)
        # inside: P[t, s] = exp(F_t - F_s) i_s (q_t . k_s), s <= t
        logdiff = Fc[:, :, None] - Fc[:, None]         # (B, c, c, H)
        w = torch.where(tril, torch.exp(logdiff), 0.0)
        s = torch.einsum("bthd,bshd->btsh", q_, k_)
        Pm = s * w * ig[:, None]
        y = cross + torch.einsum("btsh,bshd->bthd", Pm, v_)
        denom = cross_n + Pm.sum(dim=2)
        ys.append(y / torch.clamp(denom.abs(), min=1.0)[..., None])
        # the state at the chunk's end
        kw = k_ * (torch.exp(Fc[:, -1:] - Fc) * ig)[..., None]
        decay = torch.exp(Fc[:, -1])                   # (B, H)
        C0 = C0 * decay[..., None, None] + torch.einsum("bshd,bshe->bhde",
                                                        kw, v_)
        n0 = n0 * decay[..., None] + kw.sum(dim=1)
    y = torch.cat(ys, dim=1).reshape(B, L, H * dh)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["out"].to(x.dtype)
    return out, ({"C": C0, "n": n0} if return_state else None)


def mlstm_step(params, cfg: ModelConfig, x_t, state):
    """x_t: (B, D); state {'C': (B, H, dh, dh), 'n': (B, H, dh)} f32.
    Returns (out (B, D), the new state); the state given is not
    changed."""
    up = _proj(x_t, params["up"])
    x_m, z = up[:, 0], up[:, 1]
    q, k, v, log_f, i_g = _mlstm_qkvif(params, cfg, x_m)
    f = torch.exp(log_f)                                # (B, H)
    C = state["C"] * f[..., None, None] + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = state["n"] * f[..., None] + i_g[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.einsum("bhd,bhd->bh", q, n)
    y = (y / torch.clamp(denom.abs(), min=1.0)[..., None]).reshape(
        y.shape[0], -1)
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return y @ params["out"].to(x_t.dtype), {"C": C, "n": n}


def mlstm_state_init(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    H, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    return {"C": torch.zeros((batch, H, dh, dh), device=device),
            "n": torch.zeros((batch, H, dh), device=device)}


# ------------------------------------------------------------- sLSTM -------


def slstm_defs(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    return {
        "wx": P((D, 4, D), ("embed", None, "mlp")),
        "rh": P((D, 4, D), ("mlp", None, None), init="normal", scale=0.02),
        "bias": P((4, D), (None, "mlp"), init="zeros"),
        "out": P((D, D), ("mlp", "embed")),
    }


def _slstm_cell(rh, bias, x_row, h, c, n, m):
    """One step, all f32: rh (D, 4, D), bias (4, D), x_row (B, 4, D), the
    state (B, D) each."""
    g = x_row + _proj(h, rh) + bias
    log_i = g[:, 0]                              # input gate (log space)
    log_f = F.logsigmoid(g[:, 1])                # forget gate
    z = torch.tanh(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    return o * c_new / torch.clamp(n_new, min=1e-6), c_new, n_new, m_new


def slstm_forward(params, cfg: ModelConfig, x, *,
                  return_state: bool = False):
    """x: (B, L, D) -> ((B, L, D), {'h', 'c', 'n', 'm'} after the L
    positions if ``return_state`` else None).  One cell step a position,
    in order."""
    xw = _proj(x, params["wx"]).float()                # (B, L, 4, D)
    rh, bias = params["rh"].float(), params["bias"].float()
    state = slstm_state_init(cfg, x.shape[0], x.device)
    h, c, n, m = (state[k] for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(x.shape[1]):
        h, c, n, m = _slstm_cell(rh, bias, xw[:, t], h, c, n, m)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    out = y @ params["out"].to(x.dtype)
    if not return_state:
        return out, None
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_step(params, cfg: ModelConfig, x_t, state):
    """x_t: (B, D); state {'h', 'c', 'n', 'm'} (B, D) f32.  Returns (out
    (B, D), the new state); the state given is not changed."""
    xw = _proj(x_t, params["wx"]).float()
    h, c, n, m = _slstm_cell(params["rh"].float(), params["bias"].float(),
                             xw, state["h"], state["c"], state["n"],
                             state["m"])
    out = h.to(x_t.dtype) @ params["out"].to(x_t.dtype)
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_state_init(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    D = cfg.d_model
    return {"h": torch.zeros((batch, D), device=device),
            "c": torch.zeros((batch, D), device=device),
            "n": torch.zeros((batch, D), device=device),
            "m": torch.full((batch, D), -1e30, device=device)}
