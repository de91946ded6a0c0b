"""Runtime execution-scheme dispatch — the paper's co-design insight made
executable: pick MLA_rc vs MLA_ru (vs seq) from the platform's
compute-to-bandwidth ratio, batch size and cache length.

Copied, in part, from ``repro.core.schemes`` so ``auto_dispatch`` picks
the same scheme in both packages.

The decision rule is the roofline argument of the paper's Fig 5: estimate
per-step time  t = max(flops/peak, bytes/bw)  for each scheme from the
closed-form costs in ``repro.hwmodel.attention_costs`` and take argmin.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .mla import MLAConfig


@dataclasses.dataclass(frozen=True)
class PlatformPoint:
    name: str
    peak_flops: float      # FLOP/s (bf16)
    hbm_bw: float          # B/s
    dtype_bytes: int = 2

    @property
    def ridge_oi(self) -> float:
        return self.peak_flops / self.hbm_bw


def cache_width(cfg: MLAConfig, platform: PlatformPoint,
                cache_dtype: Optional[str] = None) -> float:
    """Per-element byte width of the latent pool under ``cache_dtype``
    (None / 'bf16' -> the platform's compute width; 'int8' / 'fp8' -> the
    1-byte payload plus the per-row f32 scale overhead amortized over the
    row, see core.cache.cache_element_bytes)."""
    from .cache import cache_element_bytes  # local import: no cycle
    return cache_element_bytes(cfg.kv_lora_rank, cfg.qk_rope_dim,
                               dtype_bytes=platform.dtype_bytes,
                               cache_dtype=cache_dtype)


def step_time(scheme: str, cfg: MLAConfig, platform: PlatformPoint,
              cache_len: int, batch: int = 1,
              paged_block: int = 0,
              cache_dtype: Optional[str] = None) -> float:
    """``paged_block > 0``: cost the paged latent cache (whole-block reads
    + block-table traffic).  ``cache_dtype`` prices a
    quantized latent pool (:func:`cache_width`): the cache streams
    shrink while weights/activations stay at the compute width."""
    from ..hwmodel import attention_costs as ac  # local import: no cycle
    c = ac.mla_decode_cost(cfg, scheme=scheme, cache_len=cache_len,
                           batch=batch, dtype_bytes=platform.dtype_bytes,
                           paged_block=paged_block,
                           cache_dtype_bytes=cache_width(cfg, platform,
                                                         cache_dtype))
    return max(c.flops / platform.peak_flops, c.bytes / platform.hbm_bw)


def auto_dispatch(cfg: MLAConfig, platform: PlatformPoint, cache_len: int,
                  batch: int = 1, candidates=("seq", "rc", "ru"),
                  paged_block: int = 0,
                  cache_dtype: Optional[str] = None) -> str:
    """Return the fastest scheme for this (platform, cache, batch) point.

    The continuous-batching runtime calls this EVERY step on the live
    (batch, max cache_len) point, so the rc/ru/seq choice adapts as the
    batch composition changes (the paper: "the choice between them can be
    made dynamically").  The JAX package's per-device (``dp_shards``)
    and speculative-verify (``verify_k``) dispatch come with the port's
    mesh and speculative decoding."""
    return min(candidates, key=lambda s: step_time(s, cfg, platform,
                                                   cache_len, batch,
                                                   paged_block=paged_block,
                                                   cache_dtype=cache_dtype))
