"""The port's HTTP/SSE frontend (``repro_torch.launch.server``) against the
JAX package's (``repro.launch.server``): each serves its own synchronous
engine on the f32 smoke config (drop-free MoE capacity, the same
weights) on an ephemeral 127.0.0.1 port, and both get the same requests
in the same order, so rids agree.  Held byte for byte: the blocking
single-completion body (the legacy wire format), the SSE stream, the
``n`` choices (blocking and streamed), a stop sequence's hold-back, and
the 400 / 404 error bodies.  Then, on the port alone, through the async
engine: a mid-decode cancel frees every block, and the radix prefix
cache stays clean after one.

Every test runs under its own deadline (SIGALRM), every HTTP call under
a socket timeout, and each server is shut down when its test or module
ends, so no test can hang the suite.
"""
import dataclasses
import json
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.launch.server import Frontend as JFrontend
from repro.runtime import PagedMLAEngine as JEngine
import repro_torch.configs as tconfigs
from repro_torch.launch.server import Frontend as TFrontend
from repro_torch.obs import Telemetry
from repro_torch.runtime import AsyncPagedMLAEngine as TAsync
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
PROMPT = [5, 9, 3, 7, 11, 2]
DEADLINE_S = 240
HTTP_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def deadline():
    """Fail a test that runs past DEADLINE_S instead of hanging."""
    def expire(*_):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


ENGINE_KW = dict(num_blocks=32, block_size=8, max_batch=2,
                 max_blocks_per_req=10, scheme="seq", prefill_chunk=8)


def _jengine(jcfg, jp, **kw):
    import jax.numpy as jnp
    return JEngine(jcfg, jp, compute_dtype=jnp.float32, **ENGINE_KW, **kw)


def _tengine(tcfg, tp, cls=TEngine, **kw):
    return cls(tcfg, tp, device="cpu", **ENGINE_KW, **kw)


@pytest.fixture(scope="module")
def servers(models_pair):
    """(JAX frontend, port frontend), each on its own sync engine."""
    jcfg, tcfg, jp, tp = models_pair
    jfe = JFrontend(_jengine(jcfg, jp), port=0).start()
    tfe = TFrontend(_tengine(tcfg, tp), port=0).start()
    yield jfe, tfe
    for fe in (jfe, tfe):
        fe.stop()


def _call(fe, path, payload=None, raw=None):
    """(status, body bytes) of a POST (``payload`` as JSON, or ``raw``
    bytes) or, with neither, a GET."""
    url = f"http://{fe.host}:{fe.port}{path}"
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(servers, path, payload=None, raw=None):
    (j_status, j_body), (t_status, t_body) = (
        _call(fe, path, payload, raw) for fe in servers)
    assert t_status == j_status
    assert t_body == j_body
    return t_status, t_body


def _events(body: bytes):
    out, ev = [], None
    for line in body.decode().splitlines():
        if line.startswith("event: "):
            ev = line[len("event: "):]
        elif line.startswith("data: "):
            out.append((ev, json.loads(line[len("data: "):])))
    return out


def _reference(tcfg, tp, prompt, max_new):
    """The port's sync engine run directly, no HTTP."""
    eng = _tengine(tcfg, tp)
    eng.run([TRequest(rid=0, prompt=np.asarray(prompt, np.int32),
                      sampling=TSP(max_tokens=max_new))])
    return [int(t) for t in eng.sched.finished[0].output]


# ------------------------------------------------------- the wire format ----


def test_blocking_body_byte_for_byte(models_pair, servers):
    _, tcfg, _, tp = models_pair
    status, body = _both(servers, "/v1/generate",
                         {"prompt": PROMPT, "max_tokens": 6})
    r = json.loads(body)
    assert status == 200 and list(r) == ["rid", "finish_reason", "output"]
    assert body == json.dumps({"rid": r["rid"], "finish_reason": "length",
                               "output": _reference(tcfg, tp, PROMPT,
                                                    6)}).encode()


@pytest.mark.parametrize("payload", [
    {"prompt": PROMPT, "max_tokens": 6, "stream": True},
    {"prompt": [8, 1, 4, 4, 2, 9, 13], "max_tokens": 5, "stream": True},
    {"prompt": PROMPT, "max_tokens": 4, "n": 2, "stream": True},
    {"prompt": PROMPT, "max_tokens": 3, "n": 1, "stream": True},
], ids=["sse", "sse-other-prompt", "sse-n2", "sse-explicit-n1"])
def test_sse_stream_byte_for_byte(models_pair, servers, payload):
    _, tcfg, _, tp = models_pair
    status, body = _both(servers, "/v1/generate", payload)
    evs = _events(body)
    assert status == 200 and evs[0][0] == "start" and evs[-1][0] == "done"
    want = _reference(tcfg, tp, payload["prompt"], payload["max_tokens"])
    if "n" in payload:
        for c in evs[-1][1]["choices"]:
            toks = [d["token"] for e, d in evs
                    if e == "token" and d["choice"] == c["index"]]
            assert toks == c["tokens"] == want   # greedy: forks agree
    else:
        assert [d["token"] for e, d in evs if e == "token"] \
            == evs[-1][1]["output"] == want


@pytest.mark.parametrize("n", [1, 2])   # a group needs n <= max_batch slots
def test_n_choices_byte_for_byte(models_pair, servers, n):
    _, tcfg, _, tp = models_pair
    status, body = _both(servers, "/v1/generate",
                         {"prompt": PROMPT, "max_tokens": 5, "n": n})
    r = json.loads(body)
    assert status == 200 and set(r) == {"rid", "choices"}
    want = _reference(tcfg, tp, PROMPT, 5)
    assert [c["index"] for c in r["choices"]] == list(range(n))
    assert all(c["tokens"] == want and c["finish_reason"] == "length"
               for c in r["choices"])


def test_stop_sequence_holds_back_byte_for_byte(models_pair, servers):
    _, tcfg, _, tp = models_pair
    free = _reference(tcfg, tp, PROMPT, 8)
    status, body = _both(servers, "/v1/generate",
                         {"prompt": PROMPT, "max_tokens": 8,
                          "stop": [free[2:4]], "stream": True})
    evs = _events(body)
    done = evs[-1][1]
    assert done["finish_reason"] == "stop" and done["output"] == free[:2]
    toks = [d["token"] for e, d in evs if e == "token"]
    assert toks == done["output"][:len(toks)]


@pytest.mark.parametrize("path,payload,raw", [
    ("/v1/generate", {"prompt": [5, 9], "max_tokens": 4, "n": 0}, None),
    ("/v1/generate", {"prompt": [5, 9], "max_tokens": 4,
                      "temperature": -1}, None),
    ("/v1/generate", {"prompt": [5, 9], "max_tokens": 0}, None),
    ("/v1/generate", {"prompt": [5, 9], "max_tokens": 4,
                      "temperature": 0.7}, None),
    ("/v1/generate", {"prompt": [5, 9], "max_tokens": 4, "top_k": 3}, None),
    ("/v1/generate", {"prompt": [5, 9], "max_tokens": 4, "seed": 9}, None),
    ("/v1/generate", {"max_tokens": 4}, None),
    ("/v1/generate", {"prompt": [], "max_tokens": 4}, None),
    ("/v1/generate", None, b"{not json"),
    ("/v1/cancel", None, b"{not json"),
    ("/v1/nowhere", {"prompt": [5]}, None),
    ("/v1/nowhere", None, None),
], ids=["n0", "neg-temp", "max0", "temp-mismatch", "top-k-mismatch",
        "seed-mismatch", "no-prompt", "empty-prompt", "bad-json",
        "bad-json-cancel", "post-404", "get-404"])
def test_error_bodies_byte_for_byte(servers, path, payload, raw):
    status, body = _both(servers, path, payload, raw)
    err = json.loads(body)["error"]
    assert status == (404 if "nowhere" in path else 400)
    assert err["type"] == ("not_found" if status == 404
                           else "invalid_request") and err["message"]


def test_health_and_metrics_answer(servers):
    (_, jh), (_, th) = (_call(fe, "/v1/health") for fe in servers)
    assert list(json.loads(th)) == list(json.loads(jh))
    assert json.loads(th)["ok"]
    status, body = _call(servers[1], "/v1/metrics")
    assert status == 200 and json.loads(body)["summary"]["decode_tokens"] > 0


# ------------------------------------------------ cancel, on the port ----


def _drain(fe, timeout=HTTP_TIMEOUT_S):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        h = json.loads(_call(fe, "/v1/health")[1])
        if h["active"] == 0 and h["waiting"] == 0:
            return h
        time.sleep(0.02)
    raise TimeoutError("engine did not drain")


def _stream_until_tokens(fe, payload, n_tokens=2):
    """Open a stream; return (rid, response) once n_tokens arrived."""
    req = urllib.request.Request(
        f"http://{fe.host}:{fe.port}/v1/generate",
        json.dumps(dict(payload, stream=True)).encode(),
        {"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S)
    rid, seen, ev = None, 0, None
    for line in resp:
        line = line.decode().strip()
        if line.startswith("event: "):
            ev = line[len("event: "):]
        elif line.startswith("data: "):
            d = json.loads(line[len("data: "):])
            if ev == "start":
                rid = d["rid"]
            elif ev == "token":
                seen += 1
                if seen >= n_tokens:
                    return rid, resp
    raise AssertionError("the stream ended before its tokens arrived")


@pytest.mark.parametrize("cls", [TEngine, TAsync], ids=["sync", "async"])
def test_cancel_mid_decode_frees_blocks(models_pair, cls):
    _, tcfg, _, tp = models_pair
    eng = _tengine(tcfg, tp, cls, enable_prefix_cache=False)
    fe = TFrontend(eng, port=0).start()
    try:
        rid, resp = _stream_until_tokens(fe, {"prompt": PROMPT,
                                              "max_tokens": 70})
        assert eng.sched.allocator.num_allocated > 0
        assert _call(fe, "/v1/cancel", {"rid": rid})[0] == 200
        evs = _events(resp.read())
        resp.close()
        assert evs[-1] == ("done", evs[-1][1])
        assert evs[-1][1]["finish_reason"] == "cancelled"
        _drain(fe)
        # no prefix cache: the cancel returned every block
        assert eng.sched.allocator.num_allocated == 0
        assert eng.sched.allocator.refcount == {}
        status, body = _call(fe, "/v1/generate",
                             {"prompt": PROMPT, "max_tokens": 5})
        assert json.loads(body)["output"] == _reference(tcfg, tp, PROMPT, 5)
    finally:
        fe.stop()


def test_cancel_leaves_radix_cache_clean(models_pair):
    _, tcfg, _, tp = models_pair
    tel = Telemetry.on(trace=False, metrics=True, drift=False)
    eng = _tengine(tcfg, tp, TAsync, telemetry=tel)    # prefix cache on
    fe = TFrontend(eng, port=0).start()
    try:
        rid, resp = _stream_until_tokens(fe, {"prompt": PROMPT,
                                              "max_tokens": 70})
        _call(fe, "/v1/cancel", {"rid": rid})
        _events(resp.read())
        resp.close()
        _drain(fe)
        # cached blocks may stay (refcount 0, evictable); nothing holds
        # a live reference
        assert all(rc == 0 for rc in eng.sched.allocator.refcount.values())
        # a request with the same prefix hits the cache and still gets
        # the reference's tokens
        status, body = _call(fe, "/v1/generate",
                             {"prompt": PROMPT, "max_tokens": 6})
        assert json.loads(body)["output"] == _reference(tcfg, tp, PROMPT, 6)
        assert eng.sched.prefix.summary()["prefix_hit_tokens"] > 0
        m = json.loads(_call(fe, "/v1/metrics")[1])
        assert m["metrics"]["histograms"]["step_ms"]["count"] > 0
    finally:
        fe.stop()
