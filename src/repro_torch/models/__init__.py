"""Model API of the port (serving and training of decoder-only models:
MLA, contiguous and paged; the attention families and the recurrent ones,
Jamba and xLSTM, contiguous):

    model_defs(cfg)                                   param definitions
    forward(params, cfg, tokens, embeds=..., ...)     -> logits, aux
    prefill(params, cfg, tokens, embeds=..., capacity=...)
                                                      -> logits, cache
    decode_step_contiguous(params, cfg, token, cache, index, ...)
                                                      -> logits, cache
    prefill_chunk_paged(params, cfg, tokens, pool, block_tables, lengths,
                        n_valid, ...)                 -> logits, pool
    verify_chunk_paged(params, cfg, tokens, pool, block_tables, lengths,
                       n_valid, ...)                  -> (B, C, V) logits,
                                                         pool
    decode_step(params, cfg, token, pool, block_tables, lengths, ...)
                                                      -> logits, pool
    init_cache(cfg, batch, capacity, dtype, device)
    init_paged_cache(cfg, num_blocks, block_size, dtype, device,
                     cache_dtype)
"""
from __future__ import annotations

from . import lm
from .common import ModelConfig, Sub
from .lm import (decode_step, decode_step_contiguous, forward, init_cache,
                 init_paged_cache, prefill, prefill_chunk_paged,
                 verify_chunk_paged)


def model_defs(cfg: ModelConfig):
    if cfg.family == "encdec":
        raise NotImplementedError("the port serves decoder-only models; "
                                  "encoder-decoder is on ROADMAP.md")
    return lm.lm_defs(cfg)


__all__ = ["ModelConfig", "Sub", "decode_step", "decode_step_contiguous",
           "forward", "init_cache", "init_paged_cache", "lm", "model_defs",
           "prefill", "prefill_chunk_paged", "verify_chunk_paged"]
