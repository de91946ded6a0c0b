"""Model API of the port, dispatched on ``cfg.family`` as in the reference
('encdec' -> ``whisper``, everything else -> the decoder-only ``lm``
stack: MLA, contiguous and paged; the attention families and the
recurrent ones, Jamba and xLSTM, contiguous):

    model_defs(cfg)                                   param definitions
    forward(params, cfg, tokens, embeds=..., ...)     -> logits, aux
    prefill(params, cfg, tokens, embeds=..., capacity=...)
                                                      -> logits, cache
    decode_step_contiguous(params, cfg, token, cache, index, ...)
                                                      -> logits, cache
    init_cache(cfg, batch, capacity, dtype, device)

and the paged forms, for decoder-only MLA models (an encoder-decoder
raises ``NotImplementedError``, as in the reference):

    prefill_chunk_paged(params, cfg, tokens, pool, block_tables, lengths,
                        n_valid, ...)                 -> logits, pool
    verify_chunk_paged(params, cfg, tokens, pool, block_tables, lengths,
                       n_valid, ...)                  -> (B, C, V) logits,
                                                         pool
    decode_step(params, cfg, token, pool, block_tables, lengths, ...)
                                                      -> logits, pool
    init_paged_cache(cfg, num_blocks, block_size, dtype, device,
                     cache_dtype)

``embeds`` is a VLM's patch prefix or an encoder-decoder's stub frames
(B, n_frames, D).
"""
from __future__ import annotations

from . import lm, whisper
from .common import ModelConfig, Sub


def _mod(cfg: ModelConfig):
    return whisper if cfg.family == "encdec" else lm


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError("paged serving targets decoder-only MLA")


def model_defs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return whisper.whisper_defs(cfg)
    return lm.lm_defs(cfg)


def forward(params, cfg: ModelConfig, tokens, **kw):
    return _mod(cfg).forward(params, cfg, tokens, **kw)


def prefill(params, cfg: ModelConfig, tokens, **kw):
    return _mod(cfg).prefill(params, cfg, tokens, **kw)


def decode_step_contiguous(params, cfg: ModelConfig, token, cache, index,
                           **kw):
    return _mod(cfg).decode_step_contiguous(params, cfg, token, cache,
                                            index, **kw)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *args, **kw):
    return _mod(cfg).init_cache(cfg, batch, capacity, *args, **kw)


def prefill_chunk_paged(params, cfg: ModelConfig, *args, **kw):
    _decoder_only(cfg)
    return lm.prefill_chunk_paged(params, cfg, *args, **kw)


def verify_chunk_paged(params, cfg: ModelConfig, *args, **kw):
    _decoder_only(cfg)
    return lm.verify_chunk_paged(params, cfg, *args, **kw)


def decode_step(params, cfg: ModelConfig, *args, **kw):
    _decoder_only(cfg)
    return lm.decode_step(params, cfg, *args, **kw)


def init_paged_cache(cfg: ModelConfig, *args, **kw):
    _decoder_only(cfg)
    return lm.init_paged_cache(cfg, *args, **kw)


__all__ = ["ModelConfig", "Sub", "decode_step", "decode_step_contiguous",
           "forward", "init_cache", "init_paged_cache", "lm", "model_defs",
           "prefill", "prefill_chunk_paged", "verify_chunk_paged",
           "whisper"]
