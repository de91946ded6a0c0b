"""The port's telemetry (``repro_torch.obs``) against tests/test_obs.py
and the JAX package's ``repro.obs``:

  * percentile / Histogram math against numpy's linear interpolation;
  * tracer span nesting, ``validate_trace`` on good and broken traces,
    the NullTracer contract and its cost, the off singleton;
  * drift rows: the port's predictions equal the JAX drift channel's for
    the same (kind, scheme, batch, cache_len) points;
  * the paged engine with telemetry on: the trace validates, every
    lifecycle and step phase has a span, the metrics mirror
    ``engine.summary()``, drift covers every dispatched scheme — and
    tokens and EngineStats are identical to an untraced run (greedy and
    sampled);
  * the prefix cache's evict / CoW instants and the scheduler's fork
    instant; StructLogger and ``drive``'s logger; the serving CLI's
    ``--trace`` / ``--metrics``;
  * the DeepSeek-V3 smoke config's greedy tokens equal the JAX engine's.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.hwmodel.platforms import PLATFORMS as JPLATFORMS
from repro.obs import RooflineDrift as JDrift
from repro.runtime import PagedMLAEngine as JEngine
from repro.runtime import Request as JRequest
from repro.runtime import SamplingParams as JSP
import repro_torch.configs as tconfigs
from repro_torch.core.schemes import step_time
from repro_torch.hwmodel.platforms import PLATFORMS
from repro_torch.launch import serve as tserve
from repro_torch.obs import (NULL_TRACER, OFF_TELEMETRY, PID_ENGINE,
                             PID_REQUESTS, Histogram, RooflineDrift,
                             StructLogger, Telemetry, Tracer, as_logger,
                             percentile, validate_trace)
from repro_torch.runtime import (BlockAllocator, PagedMLAEngine, PrefixCache,
                                 Request, SamplingParams)
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"


# -------------------------------------------------------- percentile math --


def test_percentile_linear_interpolation():
    assert percentile([], 50) == 0.0
    assert percentile([7.0], 99) == 7.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)
    assert percentile([1.0, 2.0, 3.0, 4.0], 0) == 1.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 100) == 4.0
    vals = sorted(np.random.default_rng(0).normal(size=137).tolist())
    for p in (5, 25, 50, 75, 95, 99):
        assert percentile(vals, p) == pytest.approx(np.percentile(vals, p))


def test_histogram_summary_matches_numpy():
    h = Histogram()
    assert h.summary() == {"count": 0}
    vals = np.random.default_rng(1).exponential(size=200).tolist()
    for v in vals:
        h.record(v)
    s = h.summary()
    assert s["count"] == 200
    assert s["mean"] == pytest.approx(np.mean(vals))
    assert s["min"] == min(vals) and s["max"] == max(vals)
    for key, p in (("p50", 50), ("p95", 95), ("p99", 99)):
        assert s[key] == pytest.approx(np.percentile(vals, p))


# ------------------------------------------------------------------ tracer --


def test_tracer_spans_nest_and_validate():
    tr = Tracer()
    tr.set_process_name(PID_ENGINE, "engine")
    with tr.span("step"):
        with tr.span("schedule"):
            pass
        with tr.span("device_step"):
            pass
    tr.instant("evict", args={"n": 2})
    trace = tr.to_dict()
    assert validate_trace(trace) == []
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert names == ["schedule", "device_step", "step"]
    step = [e for e in trace["traceEvents"] if e["name"] == "step"][0]
    kids = [e for e in trace["traceEvents"]
            if e["name"] in ("schedule", "device_step")]
    assert all(e["ts"] >= step["ts"] and
               e["ts"] + e["dur"] <= step["ts"] + step["dur"] + 1e-3
               for e in kids)


def test_validate_trace_rejects_malformed():
    assert validate_trace({}) != []
    assert validate_trace({"traceEvents": [{"ph": "X"}]}) != []
    overlapping = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 0, "ts": 5.0, "dur": 10.0},
    ]}
    assert any("overlaps" in p for p in validate_trace(overlapping))
    neg = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": -1.0}]}
    assert validate_trace(neg) != []
    float_pid = {"traceEvents": [
        {"name": "a", "ph": "i", "pid": 1.0, "tid": 0, "ts": 0.0}]}
    assert any("non-integer" in p for p in validate_trace(float_pid))


def test_null_tracer_is_inert(tmp_path):
    assert not NULL_TRACER.enabled
    with NULL_TRACER.span("step") as sp:
        pass
    assert sp.dur_s == 0.0
    NULL_TRACER.instant("x")
    NULL_TRACER.complete("y", 1, 0, 0.0, 1.0)
    assert NULL_TRACER.to_dict() == {"traceEvents": []}
    with pytest.raises(RuntimeError):
        NULL_TRACER.export(str(tmp_path / "never.json"))


def test_null_span_overhead_is_negligible():
    """Telemetry that is off costs little: a generous 20 us a hook (well
    under a microsecond measured on a server CPU)."""
    n = 50_000
    span = OFF_TELEMETRY.tracer.span
    t0 = time.perf_counter()
    for _ in range(n):
        with span("step"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 20e-6, f"{per_call * 1e6:.2f} us per null span"


def test_telemetry_off_singleton():
    assert Telemetry.off() is OFF_TELEMETRY
    assert not OFF_TELEMETRY.enabled
    assert OFF_TELEMETRY.metrics is None and OFF_TELEMETRY.drift is None


def test_exporting_an_unserializable_trace_raises(tmp_path):
    tr = Tracer()
    tr.instant("x", args={"bad": object()})
    with pytest.raises(TypeError):
        tr.export(str(tmp_path / "t.json"))


# ------------------------------------------------------------------- drift --


def test_drift_unbound_is_noop_and_bound_matches_dispatcher():
    d = RooflineDrift()
    assert not d.active
    d.record_decode("seq", 2, 64, 0.01)
    assert d.rows == []
    mla = tconfigs.smoke(ARCH).mla_config()
    plat = PLATFORMS["h100"]
    d.bind(mla=mla, platform=plat, paged_block=8)
    d.record_decode("seq", 2, 64, 0.01)
    row = d.rows[0]
    assert row.pred_time_s == step_time("seq", mla, plat, cache_len=64,
                                        batch=2, paged_block=8)
    assert row.pred_bytes > 0
    assert row.ratio == pytest.approx(0.01 / row.pred_time_s)
    rep = d.report()
    assert rep["rows"] == 1 and rep["platform"] == "h100"
    assert rep["kinds"]["decode"]["schemes"] == ["seq"]
    assert "decode/seq/b2" in rep["buckets"]
    assert d.check_coverage({"seq": 3}) == []
    assert d.check_coverage({"rc": 1}) == \
        ["scheme 'rc' dispatched but has no drift row"]


@pytest.mark.parametrize("cache_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_drift_rows_equal_the_jax_drift(arch, cache_dtype):
    """The same rows recorded into both packages' drift channels carry
    the same predicted time and bytes, and the reports agree."""
    t = RooflineDrift()
    j = JDrift()
    t.bind(mla=tconfigs.full(arch).mla_config(), platform=PLATFORMS["h100"],
           paged_block=16, cache_dtype=cache_dtype)
    j.bind(mla=jconfigs.full(arch).mla_config(),
           platform=JPLATFORMS["h100"], paged_block=16,
           cache_dtype=cache_dtype)
    for d in (t, j):
        vals = iter(np.linspace(1e-3, 9e-2, 400).tolist())
        for s in ("seq", "rc", "ru", "naive"):
            for b, cl in ((1, 17), (3, 256), (8, 1040), (33, 4096)):
                d.record_decode(s, b, cl, next(vals))
                d.record_verify(s, b, cl, 3, next(vals))
        for b, L, C, impl, P in ((1, 40, 8, "pallas", 0),
                                 (8, 1024, 32, "pallas", 512),
                                 (3, 300, 32, "gather", 16)):
            d.record_prefill("seq", b, L, C, impl, next(vals),
                             cached_prefix=P)
    assert [dataclasses.asdict(r) for r in t.rows] == \
        [dataclasses.asdict(r) for r in j.rows]
    assert t.report() == j.report()


# ---------------------------------------------------- engine end-to-end ----


@pytest.fixture(scope="module")
def smoke_model():
    cfg = dataclasses.replace(tconfigs.smoke(ARCH),
                              capacity_factor=4.0)   # drop-free: 8 / 2
    jp = np_params(jmodels.model_defs(jconfigs.smoke(ARCH)), 0)
    return cfg, from_jax_params(jp, cfg, device="cpu")


def _reqs(cfg, seed=3, n=3, fork=1):
    rng = np.random.default_rng(seed)
    return [Request(rid=i * fork,
                    prompt=rng.integers(0, cfg.vocab, (6,)).astype(np.int32),
                    arrival=i % 2,
                    sampling=SamplingParams(max_tokens=4,
                                            n=fork if i == 0 else 1))
            for i in range(n)]


def _run(cfg, params, reqs, telemetry=None, **kw):
    eng = PagedMLAEngine(cfg, params, num_blocks=24, block_size=4,
                         max_batch=3, scheme="auto",
                         platform=PLATFORMS["h100"], prefill_chunk=4,
                         impl="kernel", telemetry=telemetry, device="cpu",
                         **kw)
    eng.run(reqs)
    return eng


def test_engine_telemetry_end_to_end(smoke_model):
    cfg, params = smoke_model
    tel = Telemetry.on()
    eng = _run(cfg, params, _reqs(cfg), telemetry=tel)
    tel.finalize(eng)

    trace = tel.tracer.to_dict()
    assert validate_trace(trace) == []

    def names(pid):
        return {e["name"] for e in trace["traceEvents"]
                if e.get("pid") == pid and e["ph"] in ("X", "i")}

    assert {"arrival", "queued", "prefill", "decode",
            "finish"} <= names(PID_REQUESTS)
    assert {"step", "schedule", "prefill", "prefill_chunk", "device_step",
            "host_sample"} <= names(PID_ENGINE)

    summ = eng.summary()
    m = tel.metrics
    assert m.engine_summary == summ
    assert m.counter("engine.steps").value == summ["steps"]
    assert m.counter("engine.decode_tokens").value == summ["decode_tokens"]
    assert m.gauge("engine.tokens_per_s").value == \
        pytest.approx(summ["tokens_per_s"])
    n_fin = len(eng.sched.finished)
    assert m.histogram("ttft_ms").count == n_fin
    assert m.histogram("queue_delay_ms").count == n_fin
    assert m.histogram("tpot_ms").count == n_fin
    for h in ("step_ms", "pool_occupancy", "pool_allocated_bytes"):
        assert m.histogram(h).count == summ["steps"]
    for r in eng.sched.finished:
        assert 0 <= r.submit_t <= r.admit_t <= r.first_tok_t <= r.finish_t

    # drift: a row for every dispatched scheme; the decode rows' points
    # are the dispatch's, the prefill rows priced for the kernel path
    assert tel.drift.check_coverage(summ["schemes_used"],
                                    kinds=("decode",)) == []
    rep = tel.drift.report()
    assert rep["rows"] == len(tel.drift.rows) > 0
    assert {"decode", "prefill"} <= set(rep["kinds"])
    assert rep["platform"] == "h100" and rep["paged_block"] == 4
    assert sum(1 for r in tel.drift.rows if r.kind == "decode") == \
        sum(summ["schemes_used"].values())

    n_events = len(trace["traceEvents"])
    tel.finalize(eng)
    assert len(tel.tracer.to_dict()["traceEvents"]) == n_events
    d = json.loads(json.dumps(m.to_dict()))
    assert d["counters"]["engine.steps"] == summ["steps"]
    assert "ttft_ms" in d["histograms"]
    assert "engine.steps" in m.render_table()


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.9, top_k=5,
                                             sample_seed=2)])
def test_engine_identical_with_tracing_on_and_off(smoke_model, kw):
    """Tokens and every EngineStats counter are the same with telemetry
    on; the fork group's instant and its CoW copy are on the trace."""
    cfg, params = smoke_model
    plain = _run(cfg, params, _reqs(cfg, seed=7, fork=2), **kw)
    tel = Telemetry.on()
    traced = _run(cfg, params, _reqs(cfg, seed=7, fork=2), telemetry=tel,
                  **kw)
    assert {r.rid: r.output for r in traced.sched.finished} == \
        {r.rid: r.output for r in plain.sched.finished}
    a, b = plain.summary(), traced.summary()
    for k in ("steps", "decode_tokens", "prefill_tokens", "prompt_tokens",
              "prefill_chunks", "admissions", "mid_gen_admissions",
              "preemptions", "scheme_switches", "schemes_used",
              "fork_groups", "fork_children", "prefix_hit_tokens"):
        assert a[k] == b[k], k
    names = [e["name"] for e in tel.tracer.to_dict()["traceEvents"]]
    assert "fork_group" in names and "cow_copy" in names


def test_step_synchronizes_inside_device_step(smoke_model, monkeypatch):
    """Every decode tick waits on the device inside its ``device_step``
    span, and every step once more before its wall clock stops."""
    cfg, params = smoke_model
    calls = []
    real = PagedMLAEngine._sync_device
    monkeypatch.setattr(PagedMLAEngine, "_sync_device",
                        lambda self: calls.append(1) or real(self))
    eng = _run(cfg, params, _reqs(cfg, seed=9, n=2))
    ticks = sum(eng.stats.schemes_used.values())
    assert eng.stats.steps > 0 and ticks > 0
    assert len(calls) == eng.stats.steps + ticks
    assert eng.stats.wall > 0


def test_prefix_cache_evict_and_cow_instants():
    pc = PrefixCache(BlockAllocator(4), 4)
    tel = Telemetry.on(trace=True, metrics=True, drift=False)
    pc.tel = tel
    blocks = pc.alloc(2)
    pc.insert(list(range(8)), blocks)
    pc.release(blocks)
    assert pc.evict(2) == 2
    pc.count_cow()
    names = [e["name"] for e in tel.tracer.to_dict()["traceEvents"]]
    assert "prefix_evict" in names and "cow_copy" in names
    assert tel.metrics.counter("prefix_cache.evictions").value == 2
    assert tel.metrics.counter("prefix_cache.cow_copies").value == 1


# ------------------------------------------------------------------ logger --


def test_struct_logger_text_json_levels():
    lines = []
    lg = StructLogger("eng", sink=lines.append, level="info")
    lg.debug("hidden", a=1)
    lg.info("admitted", step=12, rid=3, frac=0.123456)
    lg.warning("preempt", rid=3)
    assert lines == ["[eng] admitted step=12 rid=3 frac=0.1235",
                     "[eng] preempt rid=3"]
    jlines = []
    jl = StructLogger("eng", sink=jlines.append, json_mode=True)
    jl.bind(step=5).info("tick", ms=1.5)
    assert json.loads(jlines[0]) == {"logger": "eng", "level": "info",
                                     "msg": "tick", "step": 5, "ms": 1.5}
    with pytest.raises(ValueError):
        StructLogger("x", level="verbose")
    assert StructLogger("x", level="off").silenced


def test_as_logger_adapts_legacy_callables():
    lg = StructLogger("a")
    assert as_logger(lg) is lg
    assert as_logger(None).silenced
    seen = []
    adapted = as_logger(seen.append, "loop")
    adapted.info("resumed", step=4)
    assert seen == ["[loop] resumed step=4"]
    assert not adapted.silenced


def test_drive_prefers_the_telemetry_logger(smoke_model):
    cfg, params = smoke_model
    mine, bare = [], []
    tel = Telemetry(logger=StructLogger("tel", sink=mine.append))
    eng = PagedMLAEngine(cfg, params, num_blocks=24, block_size=4,
                         max_batch=3, scheme="seq", telemetry=tel,
                         device="cpu")
    eng.run(_reqs(cfg, n=2), log_every=1, log=bare.append)
    assert bare == [] and len(mine) == eng.stats.steps
    assert mine[0].startswith("[tel] step step=1 active=")


# ------------------------------------------------------------------- CLI --


def test_serve_cli_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    tserve.main(["--arch", ARCH, "--smoke", "--paged", "--n", "3",
                 "--temperature", "0.9", "--top-k", "8", "--batch", "2",
                 "--prompt-len", "9", "--gen", "4", "--trace", str(trace),
                 "--metrics", str(metrics), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 groups forked" in out and "roofline drift" in out
    assert validate_trace(json.loads(trace.read_text())) == []
    assert json.loads(metrics.read_text())["counters"]["engine.steps"] > 0
    for flag in (["--trace", str(trace)], ["--temperature", "0.5"]):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"]
                        + flag)


# ------------------------------------------------------ the paper's config --


def test_deepseek_v3_smoke_tokens_equal_jax():
    """DeepSeek-V3's smoke config (3 dense layers, 1 shared expert) at
    drop-free capacity: greedy tokens identical to the JAX engine's."""
    arch = "deepseek-v3-671b"
    jcfg, tcfg = (dataclasses.replace(c, capacity_factor=c.n_experts
                                      / c.top_k)
                  for c in (jconfigs.smoke(arch), tconfigs.smoke(arch)))
    jp = np_params(jmodels.model_defs(jcfg), 1)
    outs = []
    for Engine, Req, SP, plats, params, kw in (
            (JEngine, JRequest, JSP, JPLATFORMS, to_jax(jp), {}),
            (PagedMLAEngine, Request, SamplingParams, PLATFORMS,
             from_jax_params(jp, tcfg, device="cpu"),
             dict(impl="kernel", device="cpu"))):
        cfg = jcfg if Engine is JEngine else tcfg
        eng = Engine(cfg, params, num_blocks=32, block_size=4, max_batch=3,
                     max_blocks_per_req=8, scheme="auto",
                     platform=plats["h100"], prefill_chunk=4, **kw)
        rng = np.random.default_rng(2)
        eng.run([Req(rid=i, prompt=rng.integers(0, cfg.vocab, 5 + 3 * i),
                     arrival=i, sampling=SP(max_tokens=6))
                 for i in range(3)])
        outs.append({r.rid: list(r.output) for r in eng.sched.finished})
    assert outs[0] == outs[1] and len(outs[0]) == 3
