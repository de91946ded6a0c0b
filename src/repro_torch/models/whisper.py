"""Whisper-style encoder-decoder (port of ``repro.models.whisper``; the
conv frontend is a stub: callers pass precomputed frame embeddings (B,
n_frames, D) in place of the log-mel conv stack).

  encoder : n_enc_layers x [LN -> bidirectional MHA -> LN -> GELU MLP]
  decoder : n_layers     x [LN -> causal self-MHA (cached)
                             -> LN -> cross-MHA over the encoder states
                             -> LN -> GELU MLP]

Pre-LN LayerNorm, GELU MLP, biases on the q, v and output projections
(none on k), learned decoder positions; the encoder's positions are the
frontend's business, so none are added here.

The JAX package stacks each stack's layers along a leading ``layers``
axis and scans them; the port keeps ``params["encoder"]`` and
``params["decoder"]`` as lists of per-layer dicts (drawn with the
stacked layout's fan-in, ``lm._stacked_fan_in``) and runs a Python loop.
Under ``cfg.remat`` each layer of the training forward runs under
``torch.utils.checkpoint``.

Attention: under ``impl='kernel'`` the encoder's self-attention (no
mask), the decoder's self-attention (causal) and its cross-attention (no
mask, L queries over n_frames keys) run in the flash-attention kernels
(K4 forward; K5 / K6 under autograd); under 'ref' in
``core.attention.gqa_attention``; under 'chunked' only the causal
self-attention runs ``chunked_attention_pairs``, the rest as 'ref' (the
reference's switch).  One-token decode attends in ``gqa_decode`` either
way, as the reference does.

Decode state (``init_cache``): {"self": [{"k", "v"} (B, capacity, H,
dh) a decoder layer], "cross": [{"k", "v"} (B, n_frames, H, dh) a
decoder layer]}.  The self cache is indexed by decoder tokens alone (no
frame is cached there); the cross cache holds the encoder states' K/V,
computed once at prefill — the extreme "reuse" point of the paper's
recompute / reuse spectrum.

    whisper_defs(cfg)                                      param defs
    encode(params, cfg, frames, ...)                 -> encoder states
    decoder_forward(params, cfg, tokens, enc, ...)   -> logits
    forward(params, cfg, tokens, embeds=frames, ...) -> logits, aux
    prefill(params, cfg, tokens, embeds=frames, capacity=...)
                                                     -> logits, cache
    decode_step_contiguous(params, cfg, token, cache, index, ...)
                                                     -> logits, cache
    init_cache(cfg, batch, capacity, dtype, device)
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..core import cache as cachelib
from ..core.attention import gqa_attention, gqa_decode
from ..core.chunked_attention import chunked_attention_pairs
from ..kernels import ops as kops
from ..nn import layers as nl
from ..nn import module as nnm
from ..nn.module import P
from .blocks import AUX_KEYS, IMPLS
from .common import ModelConfig
from .lm import _stacked_fan_in

# ------------------------------------------------------------------ defs ---


def _attn_defs(cfg: ModelConfig) -> Dict:
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {
        "w_q": P((D, H, dh), ("embed", "heads", None)),
        "b_q": P((H, dh), ("heads", None), init="zeros"),
        "w_k": P((D, H, dh), ("embed", "heads", None)),
        "w_v": P((D, H, dh), ("embed", "heads", None)),
        "b_v": P((H, dh), ("heads", None), init="zeros"),
        "w_o": P((H, dh, D), ("heads", None, "embed")),
        "b_o": P((D,), (None,), init="zeros"),
    }


def _enc_layer_defs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": nl.layernorm_defs(cfg.d_model),
        "attn": _attn_defs(cfg),
        "ln2": nl.layernorm_defs(cfg.d_model),
        "mlp": nl.mlp_defs(cfg.d_model, cfg.d_ff, kind="gelu", bias=True),
    }


def _dec_layer_defs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": nl.layernorm_defs(cfg.d_model),
        "self_attn": _attn_defs(cfg),
        "ln_x": nl.layernorm_defs(cfg.d_model),
        "cross_attn": _attn_defs(cfg),
        "ln2": nl.layernorm_defs(cfg.d_model),
        "mlp": nl.mlp_defs(cfg.d_model, cfg.d_ff, kind="gelu", bias=True),
    }


def _stack(defs: Dict, n: int):
    """n per-layer copies of ``defs``, each leaf drawn as the reference
    draws its slice of the stacked leaf."""
    return [nnm.map_defs(lambda _, p: _stacked_fan_in(p, n), defs)
            for _ in range(n)]


def whisper_defs(cfg: ModelConfig) -> Dict:
    return {
        "embed": nl.embed_defs(cfg.vocab, cfg.d_model),
        "pos_dec": P((cfg.max_seq, cfg.d_model), (None, "embed"),
                     init="normal", scale=0.02),
        "ln_enc": nl.layernorm_defs(cfg.d_model),
        "ln_dec": nl.layernorm_defs(cfg.d_model),
        "encoder": _stack(_enc_layer_defs(cfg), cfg.n_enc_layers),
        "decoder": _stack(_dec_layer_defs(cfg), cfg.n_layers),
    }


def param_count(cfg: ModelConfig) -> int:
    return nnm.count_params(whisper_defs(cfg))


# ------------------------------------------------------------- attention ---


def _proj(params, x, name: str):
    """x (B, L, D) -> (B, L, H, dh), plus the bias where there is one."""
    y = torch.einsum("bld,dhk->blhk", x, params[f"w_{name}"].to(x.dtype))
    if f"b_{name}" in params:
        y = y + params[f"b_{name}"].to(x.dtype)
    return y


def _out_proj(params, o):
    return torch.einsum("blhk,hkd->bld", o, params["w_o"].to(o.dtype)) \
        + params["b_o"].to(o.dtype)


def _attend(q, k, v, *, causal: bool, impl: str):
    """(B, Lq, H, dh) queries over (B, Lk, H, dh) keys and values."""
    if impl not in IMPLS:
        raise NotImplementedError(f"impl {impl!r}: the port runs {IMPLS}")
    if impl == "kernel":
        return kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), impl="kernel",
                              causal=causal).transpose(1, 2)
    if impl == "chunked" and causal:      # long causal self-attention
        return chunked_attention_pairs(q, k, v, True, None, 0, None)
    return gqa_attention(q, k, v, causal=causal)


def _mha(params, x, kv_src, *, causal: bool, impl: str):
    """Full-sequence MHA; kv_src = x for self-attention, the encoder
    states for cross-attention."""
    o = _attend(_proj(params, x, "q"), _proj(params, kv_src, "k"),
                _proj(params, kv_src, "v"), causal=causal, impl=impl)
    return _out_proj(params, o)


def _layers(layer, x, stack, remat: bool, *extra):
    for p in stack:
        if remat:
            x = checkpoint(layer, x, p, *extra, use_reentrant=False)
        else:
            x = layer(x, p, *extra)
    return x


# ----------------------------------------------------------------- model ---


def encode(params, cfg: ModelConfig, frames, *, impl: str = "ref",
           remat: bool = False):
    """frames: (B, n_frames, D) precomputed stub embeddings -> encoder
    states (B, n_frames, D) in the frames' dtype."""
    def layer(x, p):
        h = nl.layernorm(p["ln1"], x)
        x = x + _mha(p["attn"], h, h, causal=False, impl=impl)
        h = nl.layernorm(p["ln2"], x)
        return x + nl.mlp(p["mlp"], h, kind="gelu")

    x = _layers(layer, frames, params["encoder"], remat)
    return nl.layernorm(params["ln_enc"], x)


def _dec_embed(params, cfg: ModelConfig, tokens, pos_start: int):
    """Token embeddings plus the decoder positions from ``pos_start``,
    added in bf16 whatever the compute dtype (as the reference embeds).
    The start is taken as ``dynamic_slice_in_dim`` takes it: a negative
    one counts from the end (max_seq + start), then it is clamped to [0,
    max_seq - L]."""
    x = nl.embed(params["embed"], tokens, torch.bfloat16)
    L, S = tokens.shape[1], params["pos_dec"].shape[0]
    start = int(pos_start)
    start = min(max(start + S if start < 0 else start, 0), S - L)
    pos = params["pos_dec"][start:start + L]
    return x + pos.to(x.dtype)[None]


def decoder_forward(params, cfg: ModelConfig, tokens, enc_states, *,
                    compute_dtype=torch.bfloat16, impl: str = "ref",
                    return_hidden: bool = False, remat: bool = False):
    """Teacher-forced decoder pass.  tokens (B, L) -> logits (B, L, V), or
    with ``return_hidden`` the final-norm hidden states."""
    x = _dec_embed(params, cfg, tokens, 0).to(compute_dtype)
    enc = enc_states.to(compute_dtype)

    def layer(x, p, enc):
        h = nl.layernorm(p["ln1"], x)
        x = x + _mha(p["self_attn"], h, h, causal=True, impl=impl)
        h = nl.layernorm(p["ln_x"], x)
        x = x + _mha(p["cross_attn"], h, enc, causal=False, impl=impl)
        h = nl.layernorm(p["ln2"], x)
        return x + nl.mlp(p["mlp"], h, kind="gelu")

    x = _layers(layer, x, params["decoder"], remat, enc)
    x = nl.layernorm(params["ln_dec"], x)
    if return_hidden:
        return x
    return nl.unembed(params["embed"], x)


def forward(params, cfg: ModelConfig, tokens, *, embeds=None,
            compute_dtype=torch.bfloat16, impl: str = "ref",
            return_hidden: bool = False, **_unused):
    """Training forward: the encoder on the stub frames ``embeds`` (B,
    n_frames, D; required) and the teacher-forced decoder.  Returns
    (logits (B, L, V), aux zeros); ``scheme`` and other LM options are
    accepted and ignored, as in the reference."""
    enc = encode(params, cfg, embeds.to(compute_dtype), impl=impl,
                 remat=cfg.remat)
    out = decoder_forward(params, cfg, tokens, enc,
                          compute_dtype=compute_dtype, impl=impl,
                          return_hidden=return_hidden, remat=cfg.remat)
    aux = {k: out.new_zeros((), dtype=torch.float32) for k in AUX_KEYS}
    return out, aux


# ---------------------------------------------------------------- serving --


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    H, dh = cfg.n_heads, cfg.resolved_head_dim
    return {
        "self": [cachelib.kv_cache(batch, capacity, H, dh, dtype, device)
                 for _ in range(cfg.n_layers)],
        "cross": [cachelib.kv_cache(batch, cfg.n_frames, H, dh, dtype,
                                    device) for _ in range(cfg.n_layers)],
    }


def prefill(params, cfg: ModelConfig, tokens, *, embeds=None,
            capacity: int = 0, compute_dtype=torch.bfloat16,
            impl: str = "ref", **_unused):
    """Encode the stub frames ``embeds``, compute each layer's cross K/V
    once, run the decoder prompt.  Returns (last-token logits (B, V), a
    cache whose self K/V holds the L prompt positions padded to
    ``capacity`` (default L) and whose cross K/V holds the n_frames
    encoder positions)."""
    B, L = tokens.shape
    enc = encode(params, cfg, embeds.to(compute_dtype), impl=impl)
    x = _dec_embed(params, cfg, tokens, 0).to(compute_dtype)
    cache = {"self": [], "cross": []}
    for p in params["decoder"]:
        ck = _proj(p["cross_attn"], enc, "k")
        cv = _proj(p["cross_attn"], enc, "v")
        h = nl.layernorm(p["ln1"], x)
        q, k, v = (_proj(p["self_attn"], h, n) for n in "qkv")
        o = _attend(q, k, v, causal=True, impl=impl)
        x = x + _out_proj(p["self_attn"], o)
        h = nl.layernorm(p["ln_x"], x)
        o = _attend(_proj(p["cross_attn"], h, "q"), ck, cv, causal=False,
                    impl=impl)
        x = x + _out_proj(p["cross_attn"], o)
        h = nl.layernorm(p["ln2"], x)
        x = x + nl.mlp(p["mlp"], h, kind="gelu")
        self_kv = cachelib.kv_cache(B, capacity or L, cfg.n_heads,
                                    cfg.resolved_head_dim, x.dtype, x.device)
        cache["self"].append(cachelib.update_kv(self_kv, k, v, 0))
        cache["cross"].append({"k": ck, "v": cv})
    x = nl.layernorm(params["ln_dec"], x[:, -1])
    return nl.unembed(params["embed"], x), cache


def decode_step_contiguous(params, cfg: ModelConfig, token, cache,
                           index: int, *, compute_dtype=torch.bfloat16,
                           **_unused):
    """One decoder token.  token (B,); ``index`` a host int, the decoder
    tokens already cached (frames are not counted); the new token's self
    K/V is written there in place, and the cross-attention reads every
    cached frame (``gqa_decode`` at index n_frames - 1).  Returns (logits
    (B, V), cache)."""
    x = _dec_embed(params, cfg, token[:, None], index).to(compute_dtype)
    for p, sc, cc in zip(params["decoder"], cache["self"], cache["cross"]):
        h = nl.layernorm(p["ln1"], x)
        q, k, v = (_proj(p["self_attn"], h, n) for n in "qkv")
        sc = cachelib.update_kv(sc, k, v, index)
        o = gqa_decode(q[:, 0], sc["k"], sc["v"], index)
        x = x + _out_proj(p["self_attn"], o[:, None])
        h = nl.layernorm(p["ln_x"], x)
        o = gqa_decode(_proj(p["cross_attn"], h, "q")[:, 0], cc["k"],
                       cc["v"], cc["k"].shape[1] - 1)
        x = x + _out_proj(p["cross_attn"], o[:, None])
        h = nl.layernorm(p["ln2"], x)
        x = x + nl.mlp(p["mlp"], h, kind="gelu")
    x = nl.layernorm(params["ln_dec"], x[:, 0])
    return nl.unembed(params["embed"], x), cache
