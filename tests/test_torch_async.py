"""The port's async double-buffered engine and its fused decode + sample
step against the JAX package, on the f32 smoke config at drop-free MoE
capacity (the seed has no greedy near-ties, see
tests/test_torch_sampling.py):

  * ``steps.make_paged_sample_step`` against the JAX package's: the same
    (B,) ids, greedy and seeded, and the same pool afterwards (block 0,
    the null block, aside);
  * ``AsyncPagedMLAEngine`` against the port's synchronous engine AND the
    JAX package's synchronous ``PagedMLAEngine``: identical tokens and
    finish reasons, greedy and seeded, through staggered arrivals
    (mid-generation admission), prefix-cache hits, an n = 3 fork, a stop
    sequence, a tiny pool with recompute preemption and a mid-decode
    cancel; the port's two engines also count the same EngineStats;
  * the async trace: valid, with ``device_step`` spans on the device
    track overlapping the host's ``schedule`` spans;
  * ``prefill_impl`` and the CPU's refusal of CUDA graphs.

The JAX package's async engine is not the reference here: the port is
held to its synchronous engine, whose ticks are deterministic.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.core import mla as jmla
from repro.hwmodel.platforms import PLATFORMS as JPLATFORMS
from repro.runtime import PagedMLAEngine as JEngine
from repro.runtime import Request as JRequest
from repro.runtime import SamplingParams as JSP
from repro.runtime.steps import make_paged_sample_step as jstep
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import mla as tmla
from repro_torch.hwmodel.platforms import PLATFORMS as TPLATFORMS
from repro_torch.obs import Telemetry, validate_trace
from repro_torch.obs.trace import PID_ENGINE
from repro_torch.runtime import AsyncPagedMLAEngine as TAsync
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.runtime.engine import TID_DEVICE
from repro_torch.runtime.steps import make_paged_sample_step as tstep
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
SAMPLING = {"greedy": {}, "seeded": dict(temperature=0.8, top_k=5,
                                         sample_seed=3)}
COUNTERS = ("steps", "decode_tokens", "prefill_tokens", "prompt_tokens",
            "prefill_chunks", "admissions", "mid_gen_admissions",
            "preemptions", "scheme_switches", "schemes_used",
            "prefix_hit_tokens", "fork_groups", "fork_children")


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


# ------------------------------------------------ the fused sample step ----


@pytest.mark.parametrize("sampling", SAMPLING.values(), ids=SAMPLING.keys())
def test_sample_step_matches_jax(models_pair, sampling):
    """One chunked prefill into both packages' pools, then the fused
    decode + sample step: the same ids for every slot (idle ones too) and
    the same pools afterwards."""
    jcfg, tcfg, jp, tp = models_pair
    jp = jmla.attach_absorbed_tree(jp, jcfg.mla_config())
    tp = tmla.attach_absorbed_tree(tp, tcfg.mla_config())
    N, bs = 12, 4
    jpool = jmodels.init_paged_cache(jcfg, N, bs, jnp.float32)
    tpool = tmodels.init_paged_cache(tcfg, N, bs, torch.float32, "cpu")
    bt = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    toks = np.random.default_rng(4).integers(0, 256, (3, 6)).astype(np.int32)
    lens = np.zeros(3, np.int32)
    nv = np.asarray([6, 3, 0], np.int32)
    _, jpool = jax.jit(lambda t, pool: jmodels.prefill_chunk_paged(
        jp, jcfg, t, pool, bt, lens, nv, compute_dtype=jnp.float32,
        impl="ref", scheme="seq"))(jnp.asarray(toks), jpool)
    tmodels.prefill_chunk_paged(
        tp, tcfg, torch.from_numpy(toks).long(), tpool,
        torch.from_numpy(bt), torch.from_numpy(lens), torch.from_numpy(nv),
        compute_dtype=torch.float32, impl="kernel", scheme="seq")
    tok = np.asarray([7, 9, 0], np.int32)
    dl = np.asarray([6, 3, 0], np.int32)
    rids, poss = np.asarray([0, 5, 2]), np.asarray([7, 4, 0])
    for scheme in ("seq", "ru"):
        want, jout = jstep(jcfg, compute_dtype=jnp.float32, impl="ref",
                           scheme=scheme, **sampling)(
            jp, jnp.asarray(tok), jax.tree.map(jnp.copy, jpool),
            jnp.asarray(bt), jnp.asarray(dl), jnp.asarray(rids, jnp.uint32),
            jnp.asarray(poss, jnp.uint32))
        tcopy = jax.tree.map(torch.clone, tpool)
        got = tstep(tcfg, compute_dtype=torch.float32, impl="kernel",
                    scheme=scheme, **sampling)(
            tp, torch.from_numpy(tok).long(), tcopy, torch.from_numpy(bt),
            torch.from_numpy(dl), torch.from_numpy(rids),
            torch.from_numpy(poss))
        assert got.shape == (3,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        layers = [jout["prefix"]["l0"]] + [
            jax.tree.map(lambda x, p=p: x[p], jout["period"]["s0"])
            for p in range(3)]
        for (_, a), b in zip(tmodels.lm.layers(tcfg, tcopy), layers):
            for k in ("ckv", "krope"):
                np.testing.assert_allclose(a[k][1:].numpy(),
                                           np.asarray(b[k])[1:],
                                           atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ the engine ----


def _requests(Req, SP, vocab, stop=()):
    """A shared 12-token preamble (prefix hits), an n = 3 fork group
    (rids 4, 5, 6), a stop sequence on request 0, arrivals spread over
    the first steps (mid-generation admission)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 12)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               for n in (5, 9)] + [rng.integers(0, vocab, n)
                                   for n in (7, 14, 6)]
    gens = (10, 8, 9, 7, 11)
    return [Req(rid=4 * i if i < 2 else 4 + 3 * (i - 1), prompt=p,
                arrival=2 * i,
                sampling=SP(max_tokens=gens[i], n=3 if i == 1 else 1,
                            stop=tuple(stop) if i == 0 else ()))
            for i, p in enumerate(prompts)]


def _engine(Engine, platforms, cfg, params, num_blocks, **kw):
    return Engine(cfg, params, num_blocks=num_blocks, block_size=4,
                  max_batch=4, max_blocks_per_req=8, scheme="auto",
                  platform=platforms["h100"], prefill_chunk=8, **kw)


def _drive(eng, reqs, cancel=None):
    """``runtime.loop.drive`` with a cancel flagged just before step
    ``cancel[1]`` of request ``cancel[0]``."""
    todo = sorted(reqs, key=lambda r: r.arrival)
    i = 0
    while not (i >= len(todo) and eng.idle):
        while i < len(todo) and todo[i].arrival <= eng.stats.steps:
            eng.submit(todo[i])
            i += 1
        if cancel is not None and eng.stats.steps == cancel[1]:
            eng.request_cancel(cancel[0])
        eng.step()
        assert eng.stats.steps < 500
    outs = {r.rid: (list(map(int, r.output)), r.finish_reason)
            for r in eng.sched.finished}
    return outs, eng.summary()


# A stop hit cannot be predicted, so the async engine finds it one tick
# late and the request's blocks return one tick later: under a full pool
# that can move a preemption or an admission (never a token).  The stop
# sequence therefore rides the cases whose pool has room, and every case
# holds the two engines' counters equal.
CASES = {"roomy": dict(num_blocks=64, stop=True),
         "preempt": dict(num_blocks=12, stop=False),
         "cancel": dict(num_blocks=64, stop=True, cancel=(4, 6)),
         "stop_preempt": dict(num_blocks=12, stop=True, counters=False)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sampling", SAMPLING, ids=SAMPLING.keys())
def test_async_engine_matches_sync_engines(models_pair, sampling, case):
    jcfg, tcfg, jp, tp = models_pair
    kw = dict(CASES[case])
    cancel = kw.pop("cancel", None)
    with_stop, counters = kw.pop("stop"), kw.pop("counters", True)
    sk = SAMPLING[sampling]
    stop = ()
    if with_stop:
        # a stop 2-gram taken from request 0's own free-running output
        free, _ = _drive(_engine(TEngine, TPLATFORMS, tcfg, tp,
                                 device="cpu", impl="kernel", **kw, **sk),
                         _requests(TRequest, TSP, tcfg.vocab))
        stop = [tuple(free[0][0][3:5])]
    want, _ = _drive(_engine(JEngine, JPLATFORMS, jcfg, jp, **kw, **sk),
                     _requests(JRequest, JSP, jcfg.vocab, stop), cancel)
    runs = [_drive(_engine(E, TPLATFORMS, tcfg, tp, device="cpu",
                           impl="kernel", **kw, **sk),
                   _requests(TRequest, TSP, tcfg.vocab, stop), cancel)
            for E in (TEngine, TAsync)]
    for outs, _ in runs:
        assert outs == want
    (_, s_sync), (_, s_async) = runs
    if counters:
        assert {k: s_sync[k] for k in COUNTERS} == \
            {k: s_async[k] for k in COUNTERS}
    assert (want[0][1] == "stop") == with_stop
    assert s_sync["fork_children"] == 2
    assert s_sync["mid_gen_admissions"] > 0 and s_sync["prefix_hit_tokens"] > 0
    if case == "preempt":
        assert s_sync["preemptions"] > 0
    if cancel is not None:
        assert want[cancel[0]][1] == "cancelled"


def test_async_trace_nests_and_overlaps(models_pair):
    """``runtime.loop.drive`` serves the async engine to the end (it
    stops on ``engine.idle``, false while a step is in flight); the trace
    validates; its device_step spans sit on the device track and overlap
    the next tick's schedule span."""
    _, tcfg, _, tp = models_pair
    tel = Telemetry.on(trace=True, metrics=True, drift=True)
    eng = _engine(TAsync, TPLATFORMS, tcfg, tp, 64, device="cpu",
                  telemetry=tel)
    reqs = _requests(TRequest, TSP, tcfg.vocab)
    eng.run(reqs)                 # runtime.loop.drive reads engine.idle
    assert len(eng.sched.finished) == len(reqs) + 2 and eng.idle
    tel.finalize(eng)
    trace = tel.tracer.to_dict()
    assert validate_trace(trace) == []
    evs = [e for e in trace["traceEvents"]
           if e["ph"] == "X" and e["pid"] == PID_ENGINE]
    device = [e for e in evs
              if e["tid"] == TID_DEVICE and e["name"] == "device_step"]
    sched = [e for e in evs if e["tid"] == 0 and e["name"] == "schedule"]
    assert device and sched
    assert not [e for e in evs if e["tid"] == 0
                and e["name"] == "device_step"]
    assert any(d["ts"] < s["ts"] + s["dur"] and s["ts"] < d["ts"] + d["dur"]
               for d in device for s in sched)
    assert tel.drift.rows


@pytest.mark.parametrize("prefill_impl", ["gather", "kernel", "pallas"])
def test_prefill_impl_overrides_the_chunk_attention(models_pair,
                                                    prefill_impl):
    """``prefill_impl`` picks the chunk attention with the decode path
    pinned, as in the JAX package: the same tokens as its engine."""
    jcfg, tcfg, jp, tp = models_pair
    jimpl = "pallas" if prefill_impl != "gather" else "gather"
    want, _ = _drive(_engine(JEngine, JPLATFORMS, jcfg, jp, 64, impl="ref",
                             prefill_impl=jimpl),
                     _requests(JRequest, JSP, jcfg.vocab))
    eng = _engine(TEngine, TPLATFORMS, tcfg, tp, 64, device="cpu",
                  impl="ref", prefill_impl=prefill_impl)
    assert eng._chunk_impl() == ("ref" if prefill_impl == "gather"
                                 else "kernel")
    got, _ = _drive(eng, _requests(TRequest, TSP, tcfg.vocab))
    assert got == want


def test_engine_options_refused_where_they_cannot_run(models_pair):
    """CUDA graphs on the CPU and unknown prefill impls raise; a CPU
    engine runs eagerly unless asked."""
    _, tcfg, _, tp = models_pair
    kw = dict(num_blocks=8, block_size=4, max_batch=2, scheme="seq",
              device="cpu")
    for Engine in (TEngine, TAsync):
        with pytest.raises(ValueError, match="CUDA device"):
            Engine(tcfg, tp, cuda_graphs=True, **kw)
        with pytest.raises(ValueError, match="prefill_impl"):
            Engine(tcfg, tp, prefill_impl="dense", **kw)
        eng = Engine(tcfg, tp, **kw)
        assert not eng.cuda_graphs and eng.warm_up() == 0.0


@pytest.mark.parametrize("sampling,seed", [(SAMPLING["greedy"], 7),
                                           (SAMPLING["seeded"], 1)],
                         ids=SAMPLING.keys())
def test_async_matches_sync_at_the_configs_capacity(models_pair, sampling,
                                                    seed):
    """At the config's own MoE capacity a decode step drops tokens, and
    every slot competes for expert slots, free ones too: the async
    engine must feed a free slot what the sync engine feeds it (the
    slot's last sampled token), or live tokens differ.  12 slots, 16
    requests of staggered lengths, so slots free and refill often; with
    these seeds, free slots left with an older token change a token."""
    _, tcfg, _, tp = models_pair
    cfg = dataclasses.replace(tcfg, capacity_factor=1.25)
    rng = np.random.default_rng(seed)
    specs = [(int(rng.integers(4, 20)), int(rng.integers(3, 14)), i // 2)
             for i in range(16)]

    def requests():
        r = np.random.default_rng(seed + 100)
        return [TRequest(rid=i, prompt=r.integers(0, cfg.vocab, p),
                         arrival=a, sampling=TSP(max_tokens=g))
                for i, (p, g, a) in enumerate(specs)]

    runs = [_drive(E(cfg, tp, num_blocks=96, block_size=4, max_batch=12,
                     max_blocks_per_req=10, scheme="seq", prefill_chunk=8,
                     device="cpu", **sampling), requests())
            for E in (TEngine, TAsync)]
    assert runs[0][0] == runs[1][0]
    assert {k: runs[0][1][k] for k in COUNTERS} == \
        {k: runs[1][1][k] for k in COUNTERS}
