"""Telemetry facade wiring the tracer, metrics registry, roofline drift
tracker and structured logger into one object the serving engine takes
(copied from ``repro.obs.telemetry``).

    tel = Telemetry.on(trace=True, metrics=True, drift=True)
    eng = PagedMLAEngine(..., telemetry=tel)
    eng.run(reqs)
    tel.finalize(eng)
    tel.export(trace_path="out.json", metrics_path="metrics.json",
               drift_path="drift.json")

Disabled mode (``Telemetry.off()`` — the engine default) costs one
attribute check per instrumentation site and one no-op call per span:
the hot path never formats a string or allocates a dict on behalf of
telemetry that is off.

Cost placement: the per-STEP phase spans, step/phase histograms and
drift rows are recorded live inside ``engine.step`` (they need the
clock around the device call); everything per-REQUEST is reconstructed
in :meth:`Telemetry.finalize` from the lifecycle timestamps the
scheduler stamps onto each ``Request`` (submit/admit/first-token/finish,
one ``perf_counter`` per transition) — so request bookkeeping costs the
hot loop nothing regardless of telemetry mode.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from .drift import RooflineDrift
from .logger import StructLogger
from .metrics import MetricsRegistry
from .trace import NULL_TRACER, PID_ENGINE, PID_REQUESTS, Tracer

# EngineStats summary keys mirrored into the counters section (the
# registry "subsumes EngineStats" — parity is pinned in
# tests/test_torch_obs.py).  The reference's speculative-decoding keys
# come with the port's speculative decoding.
_ENGINE_COUNTERS = (
    "steps", "decode_tokens", "prefill_tokens", "prompt_tokens",
    "prefill_chunks", "admissions", "mid_gen_admissions", "preemptions",
    "scheme_switches", "fork_groups", "fork_children",
)
_ENGINE_GAUGES = (
    "tokens_per_s", "cache_utilization", "pool_occupancy",
)


class Telemetry:
    def __init__(self, *, tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 drift: Optional[RooflineDrift] = None,
                 logger: Optional[StructLogger] = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.drift = drift
        self.logger = logger
        self.enabled = bool(self.tracer.enabled or metrics is not None
                            or drift is not None)
        self._finalized = False

    @classmethod
    def off(cls) -> "Telemetry":
        return OFF_TELEMETRY

    @classmethod
    def on(cls, *, trace: bool = True, metrics: bool = True,
           drift: bool = True,
           logger: Optional[StructLogger] = None) -> "Telemetry":
        return cls(tracer=Tracer() if trace else None,
                   metrics=MetricsRegistry() if metrics else None,
                   drift=RooflineDrift() if drift else None, logger=logger)

    # ---------------------------------------------------------- finalize --

    def finalize(self, engine) -> "Telemetry":
        """Build the per-request lifecycle spans and the metrics snapshot
        from the engine's terminal state (idempotent).  Duck-typed on
        ``engine.sched`` / ``engine.summary()`` so obs stays import-free
        of the runtime package."""
        if self._finalized:
            return self
        self._finalized = True
        sched = engine.sched
        reqs = (list(sched.finished)
                + [r for r in sched.slots if r is not None]
                + list(sched.waiting))
        if self.tracer.enabled:
            self._emit_request_spans(reqs)
        if self.metrics is not None:
            self._snapshot_metrics(engine, sched)
        return self

    def _emit_request_spans(self, reqs) -> None:
        tr = self.tracer
        tr.set_process_name(PID_ENGINE, "engine")
        tr.set_thread_name(PID_ENGINE, 0, "step phases")
        tr.set_process_name(PID_REQUESTS, "requests")
        rel = lambda t: max(t - tr.t0, 0.0)
        for req in reqs:
            tid = int(req.rid)
            tr.set_thread_name(PID_REQUESTS, tid, f"req {req.rid}")
            if req.submit_t >= 0:
                tr.instant_at("arrival", PID_REQUESTS, tid, rel(req.submit_t))
            if req.submit_t >= 0 and req.admit_t >= 0:
                tr.complete("queued", PID_REQUESTS, tid, rel(req.submit_t),
                            rel(req.admit_t))
            if req.admit_t >= 0 and req.first_tok_t >= 0:
                tr.complete("prefill", PID_REQUESTS, tid, rel(req.admit_t),
                            rel(req.first_tok_t),
                            args={"plen": req.plen, "cached": req.n_cached})
            if req.first_tok_t >= 0 and req.finish_t >= 0:
                tr.complete("decode", PID_REQUESTS, tid,
                            rel(req.first_tok_t), rel(req.finish_t),
                            args={"new_tokens": len(req.output)})
                tr.instant_at("finish", PID_REQUESTS, tid, rel(req.finish_t))
            for t in req.preempt_ts:
                tr.instant_at("preempt", PID_REQUESTS, tid, rel(t))

    def _snapshot_metrics(self, engine, sched) -> None:
        m = self.metrics
        summ = engine.summary()
        m.engine_summary = summ
        for k in _ENGINE_COUNTERS:
            m.counter(f"engine.{k}").value = float(summ[k])
        for k in _ENGINE_GAUGES:
            m.gauge(f"engine.{k}").set(float(summ[k]))
        for k, v in summ.items():
            if k.startswith("prefix_"):
                m.gauge(f"prefix_cache.{k[len('prefix_'):]}").set(float(v))
        m.counter("requests.finished").value = float(len(sched.finished))
        qd = m.histogram("queue_delay_ms")
        ttft = m.histogram("ttft_ms")
        tpot = m.histogram("tpot_ms")
        for req in sched.finished:
            if req.submit_t >= 0 and req.admit_t >= 0:
                qd.record((req.admit_t - req.submit_t) * 1e3)
            if req.submit_t >= 0 and req.first_tok_t >= 0:
                ttft.record((req.first_tok_t - req.submit_t) * 1e3)
            n = len(req.output)
            if req.first_tok_t >= 0 and req.finish_t >= 0 and n > 1:
                tpot.record((req.finish_t - req.first_tok_t) / (n - 1) * 1e3)

    # ------------------------------------------------------------ export --

    def export(self, *, trace_path: Optional[str] = None,
               metrics_path: Optional[str] = None,
               drift_path: Optional[str] = None) -> Dict[str, str]:
        """Write the requested artifacts; returns {channel: path}."""
        written: Dict[str, str] = {}
        if trace_path:
            written["trace"] = self.tracer.export(trace_path)
        if metrics_path and self.metrics is not None:
            written["metrics"] = self.metrics.save(metrics_path)
        if drift_path and self.drift is not None:
            with open(drift_path, "w") as f:
                json.dump(self.drift.report(), f, indent=1)
            written["drift"] = drift_path
        return written


OFF_TELEMETRY = Telemetry()
