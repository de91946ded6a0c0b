"""Stdlib HTTP/SSE frontend for the port's paged MLA engines (port of
``repro.launch.server``; the same endpoints and the same bytes on the
wire).

One ``EngineWorker`` thread owns the engine (the engines are NOT
thread-safe; only ``request_cancel`` may be called from other threads)
and runs the tick loop: drain client submissions into ``engine.submit``,
``engine.step`` while work is pending, then publish newly visible tokens
into per-request stream queues that the HTTP handler threads block on.
With the async engine the worker's host work for tick N+1 overlaps the
device executing tick N — the frontend code is identical either way.

Endpoints (JSON in / JSON or SSE out; stdlib ``http.server`` only):

  POST /v1/generate   {"prompt": [ids], "max_tokens": N,
                       "stop": [[ids], ...], "stream": bool,
                       "temperature": f, "top_k": N, "seed": N, "n": N}
                      The body maps onto runtime.sampling.SamplingParams.
                      Without "n": stream=false returns the single-
                      completion body {"rid", "finish_reason", "output"}
                      (the reference's legacy wire format, byte for
                      byte); stream=true emits one ``event: token`` per
                      generated token and a final ``event: done``.  WITH
                      "n" (parallel sampling — one prefill, the sequence
                      forks n ways copy-on-write): blocking responses
                      carry ``choices`` = [{"index", "tokens",
                      "finish_reason"}, ...]; SSE token events carry
                      their ``choice`` index and ``done`` carries the
                      full choices array.  The group occupies rids
                      [rid, rid + n); each choice c cancels
                      independently via rid + c.
                      Validation errors (empty prompt, n < 1, negative
                      temperature, engine-config mismatch) return
                      structured JSON {"error": {"message", "type"}}
                      with status 400; unknown routes 404.
  POST /v1/cancel     {"rid": N} — thread-safe cancel; mid-decode the
                      request frees its slot/blocks at the next tick and
                      finishes with finish_reason="cancelled".  For a
                      parallel-sampling group, rid + c cancels choice c
                      alone (sibling forks keep decoding).
  GET  /v1/health     liveness + engine step/queue counters.
  GET  /v1/metrics    metrics-registry snapshot (when telemetry is on)
                      plus the engine summary.

Streaming holds back ``max(len(stop_seq)) - 1`` tokens so a stop
sequence completing across several ticks never leaks its own prefix to
the client; the held tokens flush with ``event: done``.  A client
disconnect mid-stream (BrokenPipeError on write) cancels the request —
every fork of it, for a group — so its blocks return to the pool
instead of decoding to max_tokens.
"""
from __future__ import annotations

import itertools
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..runtime.sampling import SamplingParams
from ..runtime.scheduler import Request


class _Stream:
    """Per-request token channel between the worker and a handler.

    For a parallel-sampling group (``n > 1``) one stream serves the
    whole group: the parent request is attached at submit, the fork
    children after ``engine.submit`` materializes them, and the queue
    carries ("token", choice, index, token) items plus one final
    ("done", choices) once EVERY member finished.  ``n == 1`` keeps the
    single-completion item shapes ("token", token) / ("done", reason,
    output)."""

    __slots__ = ("rid", "reqs", "n", "q", "emitted", "hold")

    def __init__(self, rid: int, req: Request, n: int = 1):
        self.rid = rid
        self.reqs = [req]               # parent first; children attach later
        self.n = n
        self.q: "queue.Queue[Tuple]" = queue.Queue()
        self.emitted = [0]
        # stop sequences can complete across ticks; never emit a token
        # that a later match could retro-truncate.
        self.hold = max((len(s) for s in req.stop), default=1) - 1

    @property
    def req(self) -> Request:
        return self.reqs[0]

    def attach_children(self, children: List[Request]) -> None:
        self.reqs.extend(children)
        self.emitted.extend(0 for _ in children)


class EngineWorker(threading.Thread):
    """Single thread that owns the engine and ticks it.

    Submissions arrive via ``submit`` (any thread), cancellation via
    ``cancel`` (delegates to the engine's thread-safe flag).  The loop
    sleeps on a condition variable while the engine is idle and no
    submissions are pending, so an unused server costs nothing.
    """

    def __init__(self, engine, *, idle_wait_s: float = 0.05):
        super().__init__(daemon=True, name="engine-worker")
        self.engine = engine
        self._idle_wait_s = idle_wait_s
        self._cv = threading.Condition()
        self._pending: List[Tuple[Request, _Stream]] = []
        self._streams: Dict[int, _Stream] = {}
        self._rids = itertools.count()
        self._stopping = False

    # ------------------------------------------------------- client API ----
    def submit(self, prompt, max_tokens: Optional[int] = None,
               stop: Optional[List[List[int]]] = None, *,
               sampling: Optional[SamplingParams] = None) -> _Stream:
        """Queue a generation.  Either pass ``sampling`` (the request
        API) or the legacy ``(max_tokens, stop)`` pair, which builds the
        equivalent single-sample params.  A group submission (n > 1)
        consumes rids [rid, rid + n) — choice c of the response is
        rid + c, cancellable on its own."""
        if sampling is None:
            sampling = SamplingParams.from_legacy(
                16 if max_tokens is None else max_tokens, stop)
        with self._cv:
            rid = next(self._rids)
            for _ in range(sampling.n - 1):   # children own rid+1..rid+n-1
                next(self._rids)
            req = Request(rid=rid,
                          prompt=np.asarray(prompt, dtype=np.int32),
                          sampling=sampling)
            st = _Stream(rid, req, n=sampling.n)
            self._pending.append((req, st))
            self._streams[rid] = st
            self._cv.notify()
        return st

    def cancel(self, rid: int) -> None:
        self.engine.request_cancel(rid)   # thread-safe by contract
        with self._cv:
            self._cv.notify()             # wake the loop to process it

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self.join(timeout=30)

    # ------------------------------------------------------ worker loop ----
    def run(self) -> None:
        while True:
            with self._cv:
                while (not self._stopping and not self._pending
                       and self.engine.idle and not self.engine._cancels):
                    self._cv.wait(timeout=self._idle_wait_s)
                if self._stopping:
                    return
                pending, self._pending = self._pending, []
            for req, st in pending:
                req.arrival = self.engine.stats.steps
                self.engine.submit(req)
                if st.n > 1:
                    # scheduler.submit materialized the fork children —
                    # wire them into the group stream for publishing
                    st.attach_children(req.fork_children)
            if not self.engine.idle or self.engine._cancels:
                self.engine.step()
            self._publish()

    def _publish(self) -> None:
        done = []
        for rid, st in self._streams.items():
            if st.n == 1:
                out = st.req.output
                safe = len(out) if st.req.done \
                    else max(0, len(out) - st.hold)
                while st.emitted[0] < safe:
                    st.q.put(("token", int(out[st.emitted[0]])))
                    st.emitted[0] += 1
                if st.req.done:
                    st.q.put(("done", st.req.finish_reason or "length",
                              [int(t) for t in out]))
                    done.append(rid)
                continue
            for c, req in enumerate(st.reqs):
                out = req.output
                safe = len(out) if req.done else max(0, len(out) - st.hold)
                while st.emitted[c] < safe:
                    st.q.put(("token", c, st.emitted[c],
                              int(out[st.emitted[c]])))
                    st.emitted[c] += 1
            if len(st.reqs) == st.n and all(r.done for r in st.reqs):
                st.q.put(("done", [
                    {"index": c, "tokens": [int(t) for t in r.output],
                     "finish_reason": r.finish_reason or "length"}
                    for c, r in enumerate(st.reqs)]))
                done.append(rid)
        for rid in done:
            del self._streams[rid]


def _parse_sampling(body: dict) -> SamplingParams:
    """Map a /v1/generate JSON body onto validated SamplingParams."""
    return SamplingParams(
        max_tokens=int(body.get("max_tokens", 16)),
        temperature=body.get("temperature"),
        top_k=None if body.get("top_k") is None else int(body["top_k"]),
        seed=None if body.get("seed") is None else int(body["seed"]),
        stop=tuple(tuple(int(t) for t in s)
                   for s in (body.get("stop") or ())),
        n=int(body.get("n", 1))).validate()


def _make_handler(worker: EngineWorker):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0: one response per connection, no chunked framing
        # needed for the SSE stream — the close delimits it.
        protocol_version = "HTTP/1.0"

        def log_message(self, *a):      # silence per-request stderr spam
            pass

        # ------------------------------------------------------ helpers ----
        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str,
                   etype: str = "invalid_request") -> None:
            self._json(code, {"error": {"message": message, "type": etype}})

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        # ------------------------------------------------------- routes ----
        def do_GET(self):
            eng = worker.engine
            if self.path == "/v1/health":
                return self._json(200, {
                    "ok": True, "steps": eng.stats.steps,
                    "active": eng.sched.n_active,
                    "waiting": len(eng.sched.waiting),
                    "finished": len(eng.sched.finished)})
            if self.path == "/v1/metrics":
                payload = {"summary": eng.summary()}
                if eng.tel.metrics is not None:
                    payload["metrics"] = eng.tel.metrics.to_dict()
                return self._json(200, payload)
            self._error(404, f"no route {self.path}", "not_found")

        def do_POST(self):
            if self.path == "/v1/cancel":
                try:
                    body = self._body()
                except json.JSONDecodeError as e:
                    return self._error(400, f"invalid JSON: {e}")
                worker.cancel(int(body.get("rid", -1)))
                return self._json(200, {"ok": True})
            if self.path != "/v1/generate":
                return self._error(404, f"no route {self.path}",
                                   "not_found")
            try:
                body = self._body()
                prompt = body["prompt"]
                if not prompt:
                    raise ValueError("empty prompt")
                sp = _parse_sampling(body)
                # engine-config match (temperature/top_k/seed are
                # engine-wide) fails HERE, on the handler thread, as a
                # 400 — never inside the worker loop
                worker.engine.validate_sampling(sp)
            except KeyError as e:
                return self._error(400, f"missing field: {e}")
            except json.JSONDecodeError as e:
                return self._error(400, f"invalid JSON: {e}")
            except (TypeError, ValueError) as e:
                return self._error(400, str(e))
            has_n = "n" in body
            st = worker.submit(prompt, sampling=sp)
            if body.get("stream"):
                return self._stream(st, has_n)
            if not has_n:                  # the legacy single body
                while True:
                    item = st.q.get()
                    if item[0] == "done":
                        return self._json(200, {
                            "rid": st.rid, "finish_reason": item[1],
                            "output": item[2]})
            while True:
                item = st.q.get()
                if item[0] == "done":
                    # an explicit n=1 group still flows through the
                    # single-stream queue shape — wrap it as choice 0
                    choices = item[1] if st.n > 1 else [
                        {"index": 0, "tokens": item[2],
                         "finish_reason": item[1]}]
                    return self._json(200, {"rid": st.rid,
                                            "choices": choices})

        def _cancel_group(self, st: _Stream) -> None:
            for rid in range(st.rid, st.rid + st.n):
                worker.cancel(rid)

        def _stream(self, st: _Stream, has_n: bool) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                # rid first so the client can POST /v1/cancel mid-stream
                if has_n:
                    self._event("start", {"rid": st.rid, "n": st.n})
                else:
                    self._event("start", {"rid": st.rid})
            except (BrokenPipeError, ConnectionResetError):
                self._cancel_group(st)
                return
            i = 0
            while True:
                item = st.q.get()
                try:
                    if item[0] == "done":
                        if has_n:
                            choices = item[1] if st.n > 1 else [
                                {"index": 0, "tokens": item[2],
                                 "finish_reason": item[1]}]
                            self._event("done", {"rid": st.rid,
                                                 "choices": choices})
                        else:
                            self._event("done", {"rid": st.rid,
                                                 "finish_reason": item[1],
                                                 "output": item[2]})
                        return
                    if st.n > 1:
                        _, choice, idx, tok = item
                    else:
                        choice, idx, tok = 0, i, item[1]
                        i += 1
                    if has_n:
                        self._event("token", {"token": tok, "index": idx,
                                              "choice": choice})
                    else:
                        self._event("token", {"token": tok, "index": idx})
                except (BrokenPipeError, ConnectionResetError):
                    # client went away: free every fork's blocks
                    self._cancel_group(st)
                    return

        def _event(self, event: str, payload: dict) -> None:
            self.wfile.write(f"event: {event}\n"
                             f"data: {json.dumps(payload)}\n\n".encode())
            self.wfile.flush()

    return Handler


class Frontend:
    """HTTP server + engine worker pair.  ``port=0`` binds ephemeral
    (read the chosen one back from ``.port``) — used by the tests."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000):
        self.worker = EngineWorker(engine)
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self.worker))
        self.host, self.port = self.httpd.server_address[:2]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self) -> "Frontend":
        self.worker.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="http-serve")
        self._serve_thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking variant for the CLI (Ctrl-C to stop)."""
        self.worker.start()
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.worker.stop()
