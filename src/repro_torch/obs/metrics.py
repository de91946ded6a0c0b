"""Metrics registry for the serving runtime: counters, gauges, and
histograms with percentile summaries, exportable as JSON and as a
human-readable table.  Copied from ``repro.obs.metrics``.

The registry subsumes ``runtime.engine.EngineStats``: the engine's
summary (plus the prefix-cache / allocator block) is snapshotted into the
export verbatim under ``"engine"`` (parity is pinned in
tests/test_torch_obs.py), and the registry adds the request-level distributions
EngineStats cannot carry — TTFT, TPOT, queueing delay, per-phase step
times — as histograms with p50/p95/p99.

Percentile math (pinned by tests): linear interpolation between closest
ranks on the sorted sample, i.e. numpy's default ``np.percentile``
definition — p in [0, 100] maps to rank ``p/100 * (n-1)``.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional


def percentile(sorted_vals: List[float], p: float) -> float:
    """Linear-interpolation percentile of an ASCENDING-sorted sample."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-sample histogram (the serving bench records thousands of
    points, not millions — keep the math exact rather than sketched)."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def record(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    def summary(self) -> Dict[str, float]:
        if not self.values:
            return {"count": 0}
        s = sorted(self.values)
        return {
            "count": len(s),
            "mean": sum(s) / len(s),
            "min": s[0],
            "max": s[-1],
            "p50": percentile(s, 50),
            "p95": percentile(s, 95),
            "p99": percentile(s, 99),
        }


class MetricsRegistry:
    """Get-or-create registry; metric names are flat dotted strings."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.engine_summary: Optional[Dict[str, float]] = None

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    # ------------------------------------------------------------ export --

    def to_dict(self) -> Dict:
        out: Dict = {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }
        if self.engine_summary is not None:
            out["engine"] = self.engine_summary
        return out

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    def render_table(self) -> str:
        """Human summary: one aligned row per metric; histograms show
        count / mean / p50 / p95 / p99."""
        lines: List[str] = []
        w = max([len(k) for k in (*self.counters, *self.gauges,
                                  *self.histograms)] + [6])
        for k in sorted(self.counters):
            lines.append(f"  {k:<{w}}  {self.counters[k].value:>12g}")
        for k in sorted(self.gauges):
            lines.append(f"  {k:<{w}}  {self.gauges[k].value:>12.4g}")
        if self.histograms:
            lines.append(f"  {'-- histograms --':<{w}}  "
                         f"{'count':>8} {'mean':>10} {'p50':>10} "
                         f"{'p95':>10} {'p99':>10}")
            for k in sorted(self.histograms):
                s = self.histograms[k].summary()
                if not s["count"]:
                    lines.append(f"  {k:<{w}}  {0:>8}")
                    continue
                lines.append(
                    f"  {k:<{w}}  {s['count']:>8} {s['mean']:>10.4g} "
                    f"{s['p50']:>10.4g} {s['p95']:>10.4g} {s['p99']:>10.4g}")
        return "\n".join(lines)
