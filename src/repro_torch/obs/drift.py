"""Roofline drift channel: modeled step cost vs measured wall time
(copied from ``repro.obs.drift``).

The paper's contribution is a closed-form *model* of MLA serving cost,
and the runtime dispatches schemes per step off that model
(``core.schemes.auto_dispatch``) — but a model nobody compares against
measurements rots silently.  This tracker closes the loop: every engine
step records the hwmodel-predicted time and off-chip bytes for the
scheme it actually dispatched next to the measured device-step wall
time, and :meth:`RooflineDrift.report` aggregates the ratio per
(kind x scheme x batch bucket).

What the ratio compares, as in the reference: the prediction is ONE MLA
layer's attention (``step_time`` / ``prefill_time`` price one layer),
the measurement the whole model step — every layer, the MoE and dense
FFNs, the head — so ``measured / predicted`` is far above 1 even where
the attention model is exact.  What carries information is its level
per bucket on one machine and its spread (p95 / p50) step to step: a
cost-model term going wrong, or a runtime path suddenly doing more work
than the model claims, moves both.  On the CPU the level says nothing
about the platform the model is priced for.

Predictions reuse the exact functions the dispatcher consults
(``core.schemes.step_time`` / ``verify_time`` / ``prefill_time`` and the
byte totals underneath them in ``hwmodel.attention_costs``), so the
drift channel can never disagree with the dispatch about what was
promised.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .metrics import percentile


def batch_bucket(batch: int) -> int:
    """Power-of-two bucket (1, 2, 4, 8, ...) so the report stays small."""
    b = 1
    while b < batch:
        b *= 2
    return b


@dataclasses.dataclass
class DriftRow:
    kind: str          # decode | verify | prefill
    scheme: str
    batch: int
    cache_len: int
    pred_time_s: float
    pred_bytes: float
    meas_time_s: float

    @property
    def ratio(self) -> float:
        return self.meas_time_s / max(self.pred_time_s, 1e-12)


class RooflineDrift:
    """Per-step predicted-vs-measured recorder.

    Construct unbound (``RooflineDrift()``) and let the engine
    :meth:`bind` its model context (MLA shape, platform point, paged
    block size, DP shard count) at startup, or pass everything up front.
    ``record`` is a no-op until bound with a platform — an engine pinned
    to a fixed scheme with no :class:`~repro_torch.core.schemes.PlatformPoint`
    has no model to drift from.
    """

    def __init__(self, mla=None, platform=None, paged_block: int = 0,
                 dp_shards: int = 1, cache_dtype: Optional[str] = None):
        self.mla = mla
        self.platform = platform
        self.paged_block = paged_block
        self.dp_shards = dp_shards
        # cache_dtype keeps the predictions dispatcher-exact for quantized
        # pools: a drift channel still pricing bf16 cache streams would
        # report phantom "drift" the moment --cache-dtype int8 lands.
        self.cache_dtype = cache_dtype
        self.rows: List[DriftRow] = []

    def bind(self, *, mla, platform, paged_block: int,
             dp_shards: int = 1, cache_dtype: Optional[str] = None) -> None:
        self.mla = mla
        self.platform = platform
        self.paged_block = paged_block
        self.dp_shards = dp_shards
        self.cache_dtype = cache_dtype

    @property
    def active(self) -> bool:
        return self.mla is not None and self.platform is not None

    # ------------------------------------------------------------ record --

    def record_decode(self, scheme: str, batch: int, cache_len: int,
                      meas_time_s: float) -> None:
        if not self.active:
            return
        from ..core.schemes import cache_width, step_time
        from ..hwmodel import attention_costs as ac
        t = step_time(scheme, self.mla, self.platform, cache_len=cache_len,
                      batch=batch, paged_block=self.paged_block,
                      dp_shards=self.dp_shards, cache_dtype=self.cache_dtype)
        c = ac.mla_decode_cost(self.mla, scheme=scheme, cache_len=cache_len,
                               batch=batch,
                               dtype_bytes=self.platform.dtype_bytes,
                               paged_block=self.paged_block,
                               dp_shards=self.dp_shards,
                               cache_dtype_bytes=cache_width(
                                   self.mla, self.platform,
                                   self.cache_dtype))
        self.rows.append(DriftRow("decode", scheme, batch, cache_len,
                                  t, c.bytes, meas_time_s))

    def record_verify(self, scheme: str, batch: int, cache_len: int, k: int,
                      meas_time_s: float) -> None:
        if not self.active:
            return
        from ..core.schemes import cache_width, verify_time
        from ..hwmodel import attention_costs as ac
        t = verify_time(scheme, self.mla, self.platform, cache_len=cache_len,
                        k=k, batch=batch, paged_block=self.paged_block,
                        dp_shards=self.dp_shards,
                        cache_dtype=self.cache_dtype)
        c = ac.mla_verify_cost(self.mla, scheme=scheme, cache_len=cache_len,
                               k=k, batch=batch,
                               dtype_bytes=self.platform.dtype_bytes,
                               paged_block=self.paged_block,
                               dp_shards=self.dp_shards,
                               cache_dtype_bytes=cache_width(
                                   self.mla, self.platform,
                                   self.cache_dtype))
        self.rows.append(DriftRow("verify", scheme, batch, cache_len,
                                  t, c.bytes, meas_time_s))

    def record_prefill(self, scheme: str, batch: int, seq_len: int,
                       chunk: int, impl: str, meas_time_s: float,
                       cached_prefix: int = 0) -> None:
        """One row per admitted-batch prefill (the whole chunk loop, not
        per chunk — ``seq_len`` is the longest prompt in the batch, the
        extent the cost model's chunk walk covers)."""
        if not self.active:
            return
        from ..core.schemes import cache_width, prefill_time
        from ..hwmodel import attention_costs as ac
        t = prefill_time(self.mla, self.platform, seq_len=seq_len,
                         batch=batch, cached_prefix=cached_prefix,
                         chunk=chunk, paged_block=self.paged_block,
                         impl=impl, cache_dtype=self.cache_dtype)
        c = ac.mla_prefill_chunk_cost(self.mla, seq_len=seq_len, chunk=chunk,
                                      paged_block=self.paged_block,
                                      batch=batch,
                                      dtype_bytes=self.platform.dtype_bytes,
                                      cached_prefix=cached_prefix, impl=impl,
                                      cache_dtype_bytes=cache_width(
                                          self.mla, self.platform,
                                          self.cache_dtype))
        self.rows.append(DriftRow("prefill", scheme, batch, seq_len,
                                  t, c.bytes, meas_time_s))

    # ------------------------------------------------------------ report --

    def schemes_covered(self) -> Dict[str, List[str]]:
        out: Dict[str, set] = {}
        for r in self.rows:
            out.setdefault(r.kind, set()).add(r.scheme)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def report(self) -> Dict:
        """Aggregate per (kind x scheme x batch bucket): row count,
        modeled vs measured time sums, measured/modeled ratio p50 + p95,
        spread (p95/p50 — machine-speed-independent), and mean modeled
        bytes per step."""
        buckets: Dict[str, List[DriftRow]] = {}
        for r in self.rows:
            key = f"{r.kind}/{r.scheme}/b{batch_bucket(r.batch)}"
            buckets.setdefault(key, []).append(r)
        out_buckets = {}
        all_ratios: List[float] = []
        for key, rows in sorted(buckets.items()):
            ratios = sorted(r.ratio for r in rows)
            all_ratios.extend(ratios)
            p50, p95 = percentile(ratios, 50), percentile(ratios, 95)
            out_buckets[key] = {
                "n": len(rows),
                "pred_time_s": sum(r.pred_time_s for r in rows),
                "meas_time_s": sum(r.meas_time_s for r in rows),
                "pred_bytes_per_step": (sum(r.pred_bytes for r in rows)
                                        / len(rows)),
                "time_ratio_p50": p50,
                "time_ratio_p95": p95,
                "spread": p95 / max(p50, 1e-12),
            }
        all_ratios.sort()
        kinds = {}
        for kind, schemes in self.schemes_covered().items():
            kinds[kind] = {"schemes": schemes,
                           "rows": sum(1 for r in self.rows
                                       if r.kind == kind)}
        p50 = percentile(all_ratios, 50)
        p95 = percentile(all_ratios, 95)
        return {
            "platform": self.platform.name if self.platform else None,
            "paged_block": self.paged_block,
            "dp_shards": self.dp_shards,
            "cache_dtype": self.cache_dtype or "bf16",
            "rows": len(self.rows),
            "kinds": kinds,
            "buckets": out_buckets,
            "summary": {
                "time_ratio_p50": p50,
                "time_ratio_p95": p95,
                "spread": p95 / max(p50, 1e-12),
            },
        }

    def check_coverage(self, schemes_used: Dict[str, int],
                       kinds: Optional[List[str]] = None) -> List[str]:
        """Problems list: schemes the engine dispatched (engine
        ``schemes_used`` keys) that have no drift row in the expected
        kinds (decode/verify)."""
        covered = self.schemes_covered()
        seen = set()
        for kind in (kinds or ("decode", "verify")):
            seen.update(covered.get(kind, []))
        return [f"scheme '{s}' dispatched but has no drift row"
                for s in sorted(schemes_used) if s not in seen]
