"""Low-overhead span tracer emitting Chrome/Perfetto trace-event JSON
(copied from ``repro.obs.trace``: the same names and the same format).

Two implementations behind one duck-typed interface:

  * :class:`Tracer` — records spans ("ph": "X" complete events), instants
    and metadata rows into an in-memory list and serializes them as the
    trace-event JSON object format (``{"traceEvents": [...]}``), which
    loads directly in Perfetto / chrome://tracing via ``export(path)``.
  * :class:`NullTracer` — the disabled mode.  Every call short-circuits
    BEFORE any string formatting or dict allocation: ``span()`` returns a
    module-level singleton context manager and ignores its arguments, so
    an instrumented hot path costs one attribute lookup plus one call per
    span when tracing is off (well under a microsecond a span on a
    server CPU; tests/test_torch_obs.py bounds it).

Conventions (what the exporter and the tests pin):

  * timestamps are MICROseconds since tracer construction
    (``time.perf_counter`` based — monotonic, sub-µs resolution);
  * pid :data:`PID_ENGINE` (1) carries the per-step phase spans (tid 0:
    schedule / prefill / draft / verify / device_step / host_sample,
    nested under one "step" span per engine tick);
  * pid :data:`PID_REQUESTS` (2) carries per-request lifecycle spans,
    one tid per request id (arrival instant, then queued -> prefill ->
    decode complete spans, then a finish or preempt instant);
  * within one (pid, tid), "X" events are properly nested — no partial
    overlap (:func:`validate_trace` checks this).
"""
from __future__ import annotations

import json
from time import perf_counter
from typing import Dict, List, Optional

PID_ENGINE = 1
PID_REQUESTS = 2


class _NullSpan:
    """Shared no-op context manager — the disabled tracer's only span."""
    __slots__ = ()
    dur_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a no-op that ignores its
    arguments without touching them (no formatting, no allocation)."""

    enabled = False
    __slots__ = ()

    def span(self, name, pid=PID_ENGINE, tid=0):
        return _NULL_SPAN

    def complete(self, name, pid, tid, start_s, end_s, args=None):
        pass

    def instant(self, name, pid=PID_ENGINE, tid=0, args=None):
        pass

    def set_process_name(self, pid, name):
        pass

    def set_thread_name(self, pid, tid, name):
        pass

    def now(self) -> float:
        return 0.0

    def to_dict(self) -> Dict:
        return {"traceEvents": []}

    def export(self, path: str) -> None:
        raise RuntimeError("cannot export a NullTracer (tracing is off)")


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one "X" complete event on exit."""
    __slots__ = ("_tr", "_name", "_pid", "_tid", "_t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, pid: int, tid: int):
        self._tr = tracer
        self._name = name
        self._pid = pid
        self._tid = tid
        self.dur_s = 0.0

    def __enter__(self):
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter()
        self.dur_s = t1 - self._t0
        tr = self._tr
        tr.events.append({
            "name": self._name, "ph": "X", "pid": self._pid,
            "tid": self._tid, "ts": (self._t0 - tr.t0) * 1e6,
            "dur": self.dur_s * 1e6,
        })
        return False


class Tracer:
    """Recording tracer.  ``now()`` gives seconds since construction on
    the same clock the spans use, so callers can stamp external
    timestamps (e.g. request lifecycle times captured by the scheduler)
    into retrospective :meth:`complete` events."""

    enabled = True

    def __init__(self):
        self.t0 = perf_counter()
        self.events: List[Dict] = []
        self._named: set = set()

    def now(self) -> float:
        return perf_counter() - self.t0

    # ------------------------------------------------------------ events --

    def span(self, name: str, pid: int = PID_ENGINE, tid: int = 0) -> _Span:
        return _Span(self, name, pid, tid)

    def complete(self, name: str, pid: int, tid: int, start_s: float,
                 end_s: float, args: Optional[Dict] = None) -> None:
        """Retrospective "X" event from two ``now()``-clock timestamps."""
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": start_s * 1e6, "dur": max(end_s - start_s, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, pid: int = PID_ENGINE, tid: int = 0,
                args: Optional[Dict] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
              "ts": self.now() * 1e6}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant_at(self, name: str, pid: int, tid: int, at_s: float,
                   args: Optional[Dict] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
              "ts": at_s * 1e6}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ---------------------------------------------------------- metadata --

    def set_process_name(self, pid: int, name: str) -> None:
        if ("p", pid) in self._named:
            return
        self._named.add(("p", pid))
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def set_thread_name(self, pid: int, tid: int, name: str) -> None:
        if ("t", pid, tid) in self._named:
            return
        self._named.add(("t", pid, tid))
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # ------------------------------------------------------------ export --

    def to_dict(self) -> Dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path


# ------------------------------------------------------------ validation --


def validate_trace(trace: Dict) -> List[str]:
    """Structural checks on a trace-event JSON object; returns a list of
    problems (empty == valid).  Pinned by tests/test_torch_obs.py and run
    on the traced serve of chip_smoke.py:

      * top-level ``traceEvents`` list; every event carries name/ph/pid/tid
        (+ ts for non-metadata, + dur >= 0 for "X");
      * pids/tids are integers (stable identity for Perfetto tracks);
      * within each (pid, tid), "X" spans NEST — an event starting inside
        an open span must also end inside it (no partial overlap).
    """
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["top-level 'traceEvents' list missing"]
    per_track: Dict = {}
    for i, ev in enumerate(events):
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i} missing '{k}': {ev}")
                break
        else:
            if not isinstance(ev["pid"], int) or not isinstance(ev["tid"], int):
                problems.append(f"event {i}: non-integer pid/tid: {ev}")
            if ev["ph"] == "M":
                continue
            if "ts" not in ev:
                problems.append(f"event {i} missing 'ts': {ev}")
                continue
            if ev["ph"] == "X":
                if ev.get("dur", -1.0) < 0:
                    problems.append(f"event {i}: 'X' without dur >= 0: {ev}")
                    continue
                per_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    # nesting: sort by (start, -end); each span must close before any
    # enclosing span still on the stack does.
    eps = 1e-3  # µs slack: perf_counter is ns-resolution, format is float
    for track, evs in per_track.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -(e["ts"] + e["dur"])))
        stack: List = []
        for ev in evs:
            start, end = ev["ts"], ev["ts"] + ev["dur"]
            while stack and start >= stack[-1][1] - eps:
                stack.pop()
            if stack and end > stack[-1][1] + eps:
                problems.append(
                    f"track {track}: span '{ev['name']}' "
                    f"[{start:.1f}, {end:.1f}] overlaps "
                    f"'{stack[-1][0]}' ending at {stack[-1][1]:.1f}")
            stack.append((ev["name"], end))
    return problems
