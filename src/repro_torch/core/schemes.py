"""Runtime execution-scheme dispatch — the paper's co-design insight made
executable: pick MLA_rc vs MLA_ru (vs seq) from the platform's
compute-to-bandwidth ratio, batch size and cache length.

Copied from ``repro.core.schemes`` so ``auto_dispatch`` picks the same
scheme in both packages, and the drift channel (``obs.drift``) prices a
step with the same numbers as the reference's.

The decision rule is the roofline argument of the paper's Fig 5: estimate
per-step time  t = max(flops/peak, bytes/bw)  for each scheme from the
closed-form costs in ``hwmodel.attention_costs`` and take argmin.
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
    row, see core.cache.cache_element_bytes).  Every roofline entry point
    below funnels its cache terms through this so the dispatcher, the
    drift channel and the bench report price the same pool."""
    from .cache import cache_element_bytes  # local import: no cycle
    return cache_element_bytes(cfg.kv_lora_rank, cfg.qk_rope_dim,
                               dtype_bytes=platform.dtype_bytes,
                               cache_dtype=cache_dtype)


def step_time(scheme: str, cfg: MLAConfig, platform: PlatformPoint,
              cache_len: int, batch: int = 1,
              paged_block: int = 0, dp_shards: int = 1,
              cache_dtype: Optional[str] = None) -> float:
    """``paged_block > 0``: cost the paged latent cache (whole-block reads
    + block-table traffic).  ``dp_shards > 1``: per-DEVICE roofline of
    data-parallel serving — the batch-proportional cache terms shrink to
    the local batch while weight bytes stay whole (the devices run in
    lockstep, so the slowest == any one device; see
    hwmodel.attention_costs.mla_decode_cost).  ``cache_dtype`` prices a
    quantized latent pool (:func:`cache_width`): the cache streams
    shrink while weights/activations stay at the compute width."""
    from ..hwmodel import attention_costs as ac  # local import: no cycle
    c = ac.mla_decode_cost(cfg, scheme=scheme, cache_len=cache_len,
                           batch=batch, dtype_bytes=platform.dtype_bytes,
                           paged_block=paged_block, dp_shards=dp_shards,
                           cache_dtype_bytes=cache_width(cfg, platform,
                                                         cache_dtype))
    return max(c.flops / platform.peak_flops, c.bytes / platform.hbm_bw)


def verify_time(scheme: str, cfg: MLAConfig, platform: PlatformPoint,
                cache_len: int, k: int, batch: int = 1,
                paged_block: int = 0, dp_shards: int = 1,
                cache_dtype: Optional[str] = None) -> float:
    """Roofline time of one SPECULATIVE verify step (k + 1 query
    positions against the resident cache in one forward — see
    hwmodel.attention_costs.mla_verify_cost).  The spec-decode engine
    dispatches its verify scheme on this instead of :func:`step_time`:
    the k-token window amortizes weight and cache streams, which moves
    the rc/ru/seq crossover points relative to single-token decode."""
    from ..hwmodel import attention_costs as ac  # local import: no cycle
    c = ac.mla_verify_cost(cfg, scheme=scheme, cache_len=cache_len, k=k,
                           batch=batch, dtype_bytes=platform.dtype_bytes,
                           paged_block=paged_block, dp_shards=dp_shards,
                           cache_dtype_bytes=cache_width(cfg, platform,
                                                         cache_dtype))
    return max(c.flops / platform.peak_flops, c.bytes / platform.hbm_bw)


def prefill_time(cfg: MLAConfig, platform: PlatformPoint, seq_len: int,
                 batch: int = 1, cached_prefix: int = 0,
                 chunk: int = 0, paged_block: int = 0,
                 impl: str = "pallas",
                 cache_dtype: Optional[str] = None) -> float:
    """Roofline TTFT estimate for one MLA layer's prefill; ``cached_prefix``
    tokens come from the radix prefix cache (runtime.prefix_cache), so
    only the suffix is projected/written while still attending the full
    prompt.  bench_serving uses the ratio of this at the measured hit
    rate vs 0 to report the modeled TTFT effect of prefix sharing.

    ``chunk > 0 and paged_block > 0`` costs the chunked PAGED prefill
    instead (hwmodel.attention_costs.mla_prefill_chunk_cost): ``impl``
    'gather' charges the materialized block-table view the reference
    path writes + re-reads every chunk, 'pallas' the in-place paged
    reads of the fused kernel — the arithmetic-intensity delta the
    prefill kernel exists to claw back."""
    from ..hwmodel import attention_costs as ac  # local import: no cycle
    cw = cache_width(cfg, platform, cache_dtype)
    if chunk and paged_block:
        c = ac.mla_prefill_chunk_cost(cfg, seq_len=seq_len, chunk=chunk,
                                      paged_block=paged_block, batch=batch,
                                      dtype_bytes=platform.dtype_bytes,
                                      cached_prefix=cached_prefix, impl=impl,
                                      cache_dtype_bytes=cw)
    else:
        c = ac.mla_prefill_cost(cfg, seq_len=seq_len, batch=batch,
                                dtype_bytes=platform.dtype_bytes,
                                cached_prefix=cached_prefix,
                                cache_dtype_bytes=cw)
    return max(c.flops / platform.peak_flops, c.bytes / platform.hbm_bw)


def cow_copy_time(cfg: MLAConfig, platform: PlatformPoint,
                  paged_block: int, n_copies: int = 1,
                  cache_dtype: Optional[str] = None) -> float:
    """Roofline time of ``n_copies`` copy-on-write block copies in ONE
    MLA layer's latent pool: each copy streams a whole
    ``paged_block x (kv_lora_rank + qk_rope_dim)`` latent block out of
    HBM and back (read src + write dst — pure bandwidth, no FLOPs).
    This prices the device side of partial-hit tail materialization and
    write-target share breaking; the engine batches independent copies
    into one op, which changes launch overhead but not bytes moved."""
    bytes_per_block = (paged_block * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                       * cache_width(cfg, platform, cache_dtype))
    return 2.0 * n_copies * bytes_per_block / platform.hbm_bw


def fork_time(cfg: MLAConfig, platform: PlatformPoint, seq_len: int,
              n: int, paged_block: int,
              cache_dtype: Optional[str] = None) -> float:
    """Device cost of forking a just-prefilled sequence ``n`` ways for
    parallel sampling (runtime.scheduler.fork_group): the ``seq_len //
    paged_block`` FULL blocks are shared by reference — free on the
    device — and only a mid-block tail (``seq_len % paged_block != 0``)
    costs one CoW block copy per fork.  The contrast with n independent
    requests (n-1 extra prefills, or n-1 full cache re-reads on a
    perfect prefix hit) is the term bench_serving's fork rows report."""
    if n <= 1 or seq_len % paged_block == 0:
        return 0.0
    return cow_copy_time(cfg, platform, paged_block, n_copies=n - 1,
                         cache_dtype=cache_dtype)


def auto_dispatch(cfg: MLAConfig, platform: PlatformPoint, cache_len: int,
                  batch: int = 1, candidates=("seq", "rc", "ru"),
                  paged_block: int = 0, dp_shards: int = 1,
                  verify_k: int = 0,
                  cache_dtype: Optional[str] = None) -> str:
    """Return the fastest scheme for this (platform, cache, batch) point.

    The continuous-batching runtime calls this EVERY step on the live
    (batch, max cache_len) point, so the rc/ru/seq choice adapts as the
    batch composition changes (the paper: "the choice between them can be
    made dynamically").  Under data-parallel serving the engine passes
    ``dp_shards`` so the decision is made on the PER-DEVICE point (the
    local batch is what each device's roofline sees — a dispatch computed
    on the global batch would over-weight the batch-shared terms).

    ``verify_k > 0`` dispatches a SPECULATIVE verify step instead: the
    k + 1-query window amortizes the weight/cache streams all schemes
    share but multiplies the per-query FLOP terms, so the best verify
    scheme can differ from the best decode scheme at the same
    (batch, cache) point (:func:`verify_time`)."""
    if verify_k > 0:
        return min(candidates,
                   key=lambda s: verify_time(s, cfg, platform, cache_len,
                                             verify_k, batch,
                                             paged_block=paged_block,
                                             dp_shards=dp_shards,
                                             cache_dtype=cache_dtype))
    return min(candidates, key=lambda s: step_time(s, cfg, platform,
                                                   cache_len, batch,
                                                   paged_block=paged_block,
                                                   dp_shards=dp_shards,
                                                   cache_dtype=cache_dtype))
