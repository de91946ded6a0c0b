"""Speculative decoding in the port against the JAX package's: the draft
models and the acceptance rule (``repro_torch.runtime.spec``), the
scheduler's write window and ``advance_multi``, the verify step
(``models.verify_chunk_paged``) and the spec round of both paged engines,
on the f32 smoke config at drop-free MoE capacity with the same weights in
both packages (numpy draws carried across by ``repro_torch.weights``).

The counterpart of every CPU case of tests/test_spec_decode.py: the
emitted tokens equal the JAX spec engine's, the port's plain engine's and
the JAX plain engine's, greedy and seeded, for an identity draft (which
must accept every draft) and a shallow self-speculation draft (which
must reject some) across schemes; the spec counters equal the JAX
engine's; budget clipping, recompute preemption, the radix prefix cache
after rejections and the draft pool under copy-on-write behave as in the
JAX package (pools held against its eager writes, block 0 aside: the
null block's contents differ by design).  Then, on the port alone: the
async engine and the HTTP frontend on a spec engine give the sync
engine's tokens, and the telemetry records draft / verify spans and
verify drift rows.

The port's engines attend on the gathered block-table view
(``impl='ref'``, as the JAX suite's engines do); the kernel path (K1 /
K2, their plain versions on the CPU) is held to it for both drafts, and
``verify_chunk_paged`` on both.  The JAX runs share their
compiled steps (``_jax_engine``): each engine of the JAX package jits its
own step functions, and recompiling identical steps for every run would
make this file several times slower.
"""
import dataclasses
import json
import urllib.request

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
from repro.runtime import spec as jspec
from repro.runtime.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import mla as tmla
from repro_torch.hwmodel.platforms import PLATFORMS as TPLATFORMS
from repro_torch.launch import serve as tserve
from repro_torch.launch.server import Frontend as TFrontend
from repro_torch.nn import module as tnnm
from repro_torch.obs import Telemetry, validate_trace
from repro_torch.runtime import AsyncPagedMLAEngine as TAsync
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.runtime import spec as tspec
from repro_torch.runtime.scheduler import ContinuousScheduler as TScheduler
from repro_torch.runtime.steps import sample_tokens, sample_window
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
SAMPLED = dict(temperature=0.8, top_k=5, sample_seed=3)
SPEC_COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted")
COUNTERS = SPEC_COUNTERS + (
    "steps", "decode_tokens", "prefill_tokens", "prompt_tokens",
    "prefill_chunks", "admissions", "mid_gen_admissions", "preemptions",
    "scheme_switches", "schemes_used", "prefix_hit_tokens", "spec_compiles")
# the JAX spec suite's request sets: (prompt, generated, arrival) each
DEFAULT = ((6, 7, 0), (9, 5, 1), (5, 9, 3))
BUDGET = ((6, 1, 0), (7, 2, 0), (5, 5, 1))
STALE = ((6, 7, 0), (9, 5, 1), (5, 9, 3), (7, 6, 30), (6, 8, 31))
COW = ((6, 5, 0), (6, 5, 1), (6, 5, 20), (6, 5, 21))


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


def _reqs(Req, SP, vocab, specs=DEFAULT, shared_prefix=0, seed=7):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (shared_prefix,)).astype(np.int32)
    return [Req(rid=i, prompt=np.concatenate(
                [pre, rng.integers(0, vocab, (p,)).astype(np.int32)]),
                arrival=a, sampling=SP(max_tokens=g))
            for i, (p, g, a) in enumerate(specs)]


def _preempt_reqs(Req, SP, vocab):
    """Two requests that outgrow a 7-block pool (the JAX suite's)."""
    rng = np.random.default_rng(19)
    return [Req(rid=i, prompt=rng.integers(0, vocab, (6,)).astype(np.int32),
                sampling=SP(max_tokens=10)) for i in range(2)]


def _draft(spec, cfg, params, draft):
    if draft is None:
        return None, None
    if draft == "self":
        return spec.identity_draft(cfg, params)
    return spec.shallow_draft(cfg, params, draft)


ENGINE_KW = dict(block_size=4, max_batch=2, prefill_chunk=5)

# compiled steps of the JAX engines, shared by every JAX run below: the
# target's (they depend on nothing that varies here), each draft's, and
# the sampler of each sampling setting
_JAX_JITS = {}


def _share(eng, owner, method, store):
    """Make ``eng.<method>(*a)`` (a step builder that caches its step in
    ``eng.<store>``, a dict keyed by a[0] or one attribute) hand out the
    step an earlier engine built for the same ``owner`` and arguments,
    recorded in ``eng.<store>`` as if built here (the engine counts its
    steps there)."""
    build = getattr(eng, method)

    def shared(*a):
        key = (owner, method) + a
        if key not in _JAX_JITS:
            _JAX_JITS[key] = build(*a)
        elif isinstance(getattr(eng, store), dict):
            getattr(eng, store)[a[0]] = _JAX_JITS[key]
        else:
            setattr(eng, store, _JAX_JITS[key])
        return _JAX_JITS[key]
    setattr(eng, method, shared)


def _jax_engine(models_pair, *, spec_k=0, draft=None, num_blocks=40,
                scheme="seq", **kw):
    jcfg, _, jp, _ = models_pair
    dcfg, dparams = _draft(jspec, jcfg, jp, draft if spec_k else None)
    eng = JEngine(jcfg, jp, num_blocks=num_blocks,
                  compute_dtype=jnp.float32, scheme=scheme,
                  platform=JPLATFORMS["h100"], spec_k=spec_k,
                  draft_cfg=dcfg, draft_params=dparams, **ENGINE_KW, **kw)
    for method, store in (("_decode_step", "_decode_steps"),
                          ("_chunk_step", "_chunk_steps"),
                          ("_verify_step", "_verify_steps")):
        _share(eng, "target", method, store)
    if spec_k:
        _share(eng, draft, "_draft_step", "_draft_decode_step")
        _share(eng, draft, "_draft_chunk_step", "_draft_chunk_steps")
    for name in ("_copy_block", "_copy_blocks"):
        setattr(eng, name, _JAX_JITS.setdefault(name, getattr(eng, name)))
    key = ("sample", tuple(sorted(kw.items())))
    if key in _JAX_JITS:
        eng.__dict__["_sample_fn"] = _JAX_JITS[key]
    else:
        _JAX_JITS[key] = eng._sample_fn
    return eng


def _torch_engine(models_pair, *, spec_k=0, draft=None, num_blocks=40,
                  scheme="seq", cls=TEngine, impl="ref", **kw):
    _, tcfg, _, tp = models_pair
    dcfg, dparams = _draft(tspec, tcfg, tp, draft if spec_k else None)
    return cls(tcfg, tp, num_blocks=num_blocks, compute_dtype=torch.float32,
               scheme=scheme, platform=TPLATFORMS["h100"], spec_k=spec_k,
               draft_cfg=dcfg, draft_params=dparams, impl=impl,
               device="cpu", **ENGINE_KW, **kw)


def _outputs(eng):
    return {r.rid: [int(t) for t in r.output] for r in eng.sched.finished}


def _counters(eng):
    s = eng.summary()
    return {k: s[k] for k in COUNTERS}


_RUNS = {}


def _run(models_pair, pkg, reqs_fn, **kw):
    """(engine, outputs) of one run to the end; a run with the same
    arguments is made once (the tests only read the engines)."""
    key = (pkg, reqs_fn, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _run_once(models_pair, pkg, reqs_fn, **kw)
    return _RUNS[key]


def _run_once(models_pair, pkg, reqs_fn, **kw):
    if pkg == "jax":
        eng = _jax_engine(models_pair, **kw)
        eng.run(reqs_fn(JRequest, JSP, models_pair[0].vocab))
    else:
        eng = _torch_engine(models_pair, **kw)
        eng.run(reqs_fn(TRequest, TSP, models_pair[1].vocab))
    return eng, _outputs(eng)


_PLAIN = {}


def _plain(models_pair, reqs_fn, num_blocks=40, **sampling):
    """Tokens of the JAX plain engine, the same as the port's plain
    engine's (checked once per request set and sampling)."""
    key = (reqs_fn, num_blocks, tuple(sorted(sampling.items())))
    if key not in _PLAIN:
        _, jout = _run(models_pair, "jax", reqs_fn, num_blocks=num_blocks,
                       **sampling)
        _, tout = _run(models_pair, "torch", reqs_fn, num_blocks=num_blocks,
                       **sampling)
        assert tout == jout
        _PLAIN[key] = jout
    return _PLAIN[key]


def _default(R, S, v):
    return _reqs(R, S, v)


def _spec_pair(models_pair, reqs_fn, **kw):
    """The JAX and the port's spec engines on the same stream: tokens and
    counters equal, tokens equal plain decode's (on a roomy pool).
    Returns both engines."""
    sampling = {k: v for k, v in kw.items() if k in SAMPLED}
    plain = _plain(models_pair, reqs_fn, **sampling)
    jeng, jout = _run(models_pair, "jax", reqs_fn, **kw)
    teng, tout = _run(models_pair, "torch", reqs_fn, **kw)
    assert jout == plain
    assert tout == plain
    assert _counters(teng) == _counters(jeng)
    return jeng, teng


def _pool_layers(cfg, pool):
    """Per-layer pools of a JAX pool tree, period leaves unstacked."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    out = [pool["prefix"][f"l{i}"] for i in range(len(prefix))]
    for p in range(n_periods):
        out += [jax.tree.map(lambda a, p=p: a[p], pool["period"][f"s{i}"])
                for i in range(len(period))]
    return out + [pool["suffix"][f"l{i}"] for i in range(len(suffix))]


def _assert_pools_match(jcfg, jpool, tcfg, tpool):
    """Both pools' latents alike, block 0 (the null block) aside."""
    layers = list(tmodels.lm.layers(tcfg, tpool))
    jl = _pool_layers(jcfg, jpool)
    assert len(layers) == len(jl)
    for (_, a), b in zip(layers, jl):
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(a[k][1:].numpy(),
                                       np.asarray(b[k])[1:],
                                       atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- unit level --


def test_accept_length_matches_jax():
    t = np.asarray([5, 6, 7, 8])
    cases = [([5, 6, 7], t, 3), ([5, 6, 9], t, 2), ([9, 6, 7], t, 0),
             ([], t[:1], 0), ([5, 6, 7], t[:2], 1)]
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(0, 6))
        targets = rng.integers(0, 3, int(rng.integers(1, k + 2)))
        cases.append((rng.integers(0, 3, k), targets, None))
    for drafts, targets, want in cases:
        drafts = np.asarray(drafts, np.int32)
        got = tspec.accept_length(drafts, targets)
        assert got == jspec.accept_length(drafts, targets)
        if want is not None:
            assert got == want


def test_shallow_draft_matches_jax_and_shares_leaves(models_pair):
    jcfg, tcfg, jp, tp = models_pair
    jdcfg, jdparams = jspec.shallow_draft(jcfg, jp, 2)
    dcfg, dparams = tspec.shallow_draft(tcfg, tp, 2)
    assert (dcfg.name, dcfg.n_layers, dcfg.vocab) == \
        (jdcfg.name, jdcfg.n_layers, jdcfg.vocab)
    # embed / final norm and the layer dicts shared, not copied
    assert dparams["embed"] is tp["embed"]
    assert dparams["ln_f"] is tp["ln_f"]
    assert dparams["prefix"]["l0"] is tp["prefix"]["l0"]
    assert dparams["prefix"]["l1"] is tp["period"][0]["s0"]
    # leaf for leaf the JAX draft's values, laid out for the draft's plan
    want = from_jax_params(jax.device_get(jdparams), dcfg, device="cpu")
    got_leaves = jax.tree_util.tree_leaves_with_path(dparams)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert torch.equal(g, w)
    assert tnnm.map_defs(lambda _, p: tuple(p.shape),
                         tmodels.model_defs(dcfg)) == \
        jax.tree.map(lambda t: tuple(t.shape), dparams)
    # a deeper draft keeps a period: its layers are the target's dicts
    dcfg3, d3 = tspec.shallow_draft(tcfg, tp, 3)
    assert [lp for _, lp in tmodels.lm.layers(dcfg3, d3)] == \
        [lp for _, lp in tmodels.lm.layers(tcfg, tp)][:3]
    for n in (0, tcfg.n_layers):
        with pytest.raises(ValueError):
            tspec.shallow_draft(tcfg, tp, n)
    with pytest.raises(ValueError):
        tspec._assemble_layer_params(
            tspec._flat_layer_params(tp, tcfg), dcfg)
    assert tspec.parse_draft_spec("self", tcfg, tp) == (tcfg, tp)
    assert tspec.parse_draft_spec("shallow:1", tcfg, tp)[0].n_layers == 1
    for bad in ("shallow:x", "deep:2"):
        with pytest.raises(SystemExit):
            tspec.parse_draft_spec(bad, tcfg, tp)


def test_engine_validates_spec_arguments_as_jax(models_pair):
    jcfg, tcfg, jp, tp = models_pair
    kw = dict(num_blocks=8, block_size=4, max_batch=1, scheme="seq")
    cases = [(ValueError, dict(spec_k=2)),                     # no draft
             (ValueError, dict(spec_k=-1)),
             (NotImplementedError, dict(spec_k=2, prefill_mode="per_request",
                                        prefill_chunk=4, draft=True)),
             (ValueError, dict(spec_k=2, draft="vocab"))]
    for exc, case in cases:
        case = dict(case)
        draft = case.pop("draft", None)
        for cfg, params, E, extra in (
                (jcfg, jp, JEngine, dict(compute_dtype=jnp.float32)),
                (tcfg, tp, TEngine, dict(device="cpu"))):
            if draft:
                dcfg = cfg if draft is True else dataclasses.replace(
                    cfg, vocab=cfg.vocab + 1)
                case.update(draft_cfg=dcfg, draft_params=params)
            with pytest.raises(exc):
                E(cfg, params, **kw, **extra, **case)


# -------------------------------------------------------- scheduler level --


def _state(s):
    return (s.block_table.tolist(), s.lengths.tolist(),
            dict(s.allocator.refcount), sorted(s.allocator._free),
            sorted(s.prefix._node_of), sorted(s.prefix._evictable),
            [r.rid for r in s.waiting],
            [None if r is None else (r.rid, list(r.tokens)) for r in s.slots],
            sorted((r.rid, r.finish_reason, list(r.output))
                   for r in s.finished))


def _both_schedulers(**kw):
    return [(JScheduler(**kw), JRequest, JSP), (TScheduler(**kw), TRequest,
                                                 TSP)]


def test_scheduler_window_reserves_verify_blocks():
    """The JAX suite's case, on both schedulers in lockstep."""
    pair = _both_schedulers(num_blocks=16, block_size=4, max_batch=1,
                            decode_window=4)
    for s, Req, SP in pair:
        s.submit(Req(rid=0, prompt=np.zeros(5, np.int32),
                     sampling=SP(max_tokens=10)))
        [(slot, req)] = s.try_admit()
        # plen + window = 9 tokens -> 3 blocks (plain decode: 2)
        assert len(s.blocks_of[slot]) == 3
        req.tokens.append(1)
        s.lengths[slot] = 5
        s.ensure_step_capacity()                  # 5 + 4 -> 9: holds
        assert len(s.blocks_of[slot]) == 3
        s.advance_multi({slot: [2, 3, 4, 5]})     # the whole window
        assert int(s.lengths[slot]) == 9 and req.tokens == [1, 2, 3, 4, 5]
        s.ensure_step_capacity()                  # 9 + 4 -> 13: grows
        assert len(s.blocks_of[slot]) == 4
    assert _state(pair[0][0]) == _state(pair[1][0])


def test_scheduler_window_clips_to_budget_and_guards_overflow():
    pair = _both_schedulers(num_blocks=16, block_size=4, max_batch=1,
                            decode_window=4)
    for s, Req, SP in pair:
        s.submit(Req(rid=0, prompt=np.zeros(5, np.int32),
                     sampling=SP(max_tokens=2)))
        [(slot, req)] = s.try_admit()
        assert len(s.blocks_of[slot]) == 2       # window clipped to 2
        req.tokens.append(1)
        s.lengths[slot] = 5
        with pytest.raises(ValueError):           # 2 emitted > window 1
            s.advance_multi({slot: [2, 3]})
        done = s.advance_multi({slot: [2]})
        assert done and done[0].output == [1, 2]
    with pytest.raises(ValueError):
        TScheduler(num_blocks=4, block_size=4, max_batch=1, decode_window=0)
    assert _state(pair[0][0]) == _state(pair[1][0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_window_differential_drive(seed):
    """Random traffic through both schedulers with a write window of 2-5:
    submits with shared preambles, stop sequences and n-way groups,
    admissions, spec rounds (block growth with preemption and CoW, then
    ``advance_multi`` with up to a window of tokens a slot), eviction and
    cancels.  Block tables, lengths, refcounts, free lists, trie
    contents, queues, admission order, outputs and any error raised agree
    after every op."""
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=int(rng.integers(8, 14)),
              block_size=int(rng.integers(2, 5)),
              max_batch=int(rng.integers(2, 4)),
              decode_window=int(rng.integers(2, 6)),
              admission=("fcfs", "cache_aware")[seed % 2])
    pair = _both_schedulers(**kw)
    pool_tokens = (kw["num_blocks"] - 1) * kw["block_size"]
    seen = {"rounds": 0, "multi": 0, "preempted": 0}
    rid = 0
    for step in range(300):
        op = int(rng.choice(6, p=[0.2, 0.15, 0.45, 0.05, 0.05, 0.1]))
        outs = []
        if op == 0:
            plen = int(rng.integers(1, max(pool_tokens // 4, 2)))
            prompt = np.concatenate([
                np.zeros(min(plen, 4), np.int32),
                rng.integers(0, 3, max(plen - 4, 0)).astype(np.int32)])
            gen = int(rng.integers(1, 24))
            n = int(rng.integers(2, 4)) if rng.integers(0, 3) == 0 else 1
            need = -(-(plen + kw["decode_window"]) // kw["block_size"])
            if n > kw["max_batch"] or n * need > kw["num_blocks"] - 1:
                n = 1
            stop = ((1, 2),) if rng.integers(0, 4) == 0 else ()
            for s, Req, SP in pair:
                s.submit(Req(rid=rid, prompt=prompt,
                             sampling=SP(max_tokens=gen, n=n, stop=stop)))
            rid += n
        elif op == 1:
            for s, _, _ in pair:
                got = []
                for slot, req in s.try_admit(step):
                    s.commit_prefill(slot)
                    got.append((slot, req.rid, req.n_cached,
                                [(c, r.rid) for c, r in s.fork_group(slot)]))
                    s.record_prefill_sample(slot, 1, step)
                outs.append((got, s.drain_cow()))
        elif op == 2:
            draws = {sl: rng.integers(0, 3, 8).tolist()
                     for sl in range(kw["max_batch"])}
            cut = {sl: int(rng.integers(1, 9)) for sl in draws}
            for s, _, _ in pair:
                try:
                    pre = [r.rid for r in s.ensure_step_capacity()]
                except RuntimeError as e:       # a lone request outgrew it
                    outs.append(str(e))
                    continue
                cow = s.drain_cow()
                emitted = {sl: draws[sl][:min(cut[sl],
                                              s._window(s.slots[sl]))]
                           for sl in s.active_slots}
                fin = [r.rid for r in s.advance_multi(emitted, step)]
                outs.append((pre, cow, emitted, fin))
            if not isinstance(outs[-1], str):
                seen["rounds"] += 1
                seen["multi"] += any(len(v) > 1 for v in outs[-1][2].values())
                seen["preempted"] += len(outs[-1][0])
        elif op == 3:
            k = int(rng.integers(1, 3))
            outs = [s.prefix.evict(k) for s, _, _ in pair]
        elif op == 4:
            pick = int(rng.integers(0, 1 << 30))
            for s, _, _ in pair:
                rids = [r.rid for r in s.waiting] + [
                    s.slots[sl].rid for sl in s.active_slots]
                if rids:
                    r = s.cancel(rids[pick % len(rids)], step)
                    outs.append(None if r is None else r.rid)
        else:
            outs = [s.utilization() for s, _, _ in pair]
        assert outs[0] == outs[1] if outs else True, (step, op, outs)
        assert _state(pair[0][0]) == _state(pair[1][0]), (step, op)
    # the drive ran multi-token rounds and preempted (this seed's stream)
    assert seen["multi"] > 10 and seen["preempted"] > 0, seen


# ------------------------------------------------------------ verify step --


@pytest.mark.parametrize("scheme", ["seq", "rc", "ru", "naive"])
def test_verify_chunk_paged_matches_jax(models_pair, scheme):
    """Logits at every window position (B, C, V) and the pool after the
    window's writes, on both attention paths of the port (K2's plain
    version and the gathered view) against the JAX function: windows of
    5, 3 and 0 valid rows over resident prefixes of 6, 3 and 0 tokens."""
    jcfg, tcfg, jp, tp = models_pair
    jp = jmla.attach_absorbed_tree(jp, jcfg.mla_config())
    tp = tmla.attach_absorbed_tree(tp, tcfg.mla_config())
    N, bs = 12, 4
    bt = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    rng = np.random.default_rng(4)
    pre = rng.integers(0, 256, (3, 6)).astype(np.int32)
    win = rng.integers(0, 256, (3, 5)).astype(np.int32)
    lens0 = np.zeros(3, np.int32)
    nv0 = np.asarray([6, 3, 0], np.int32)
    lens = nv0.copy()
    nv = np.asarray([5, 3, 0], np.int32)
    jpool = jmodels.init_paged_cache(jcfg, N, bs, jnp.float32)
    _, jpool = jax.jit(lambda t, pool: jmodels.prefill_chunk_paged(
        jp, jcfg, t, pool, bt, lens0, nv0, compute_dtype=jnp.float32,
        impl="ref", scheme="seq"))(jnp.asarray(pre), jpool)
    want, jpool = jax.jit(lambda t, pool: jmodels.verify_chunk_paged(
        jp, jcfg, t, pool, bt, lens, nv, compute_dtype=jnp.float32,
        impl="ref", scheme=scheme))(jnp.asarray(win), jpool)
    want = np.asarray(want)
    assert want.shape == (3, 5, jcfg.vocab)
    t = lambda a: torch.from_numpy(a)
    for impl in ("kernel", "ref"):
        tpool = tmodels.init_paged_cache(tcfg, N, bs, torch.float32, "cpu")
        tmodels.prefill_chunk_paged(tp, tcfg, t(pre).long(), tpool, t(bt),
                                    t(lens0), t(nv0),
                                    compute_dtype=torch.float32, impl=impl,
                                    scheme="seq")
        got, out = tmodels.verify_chunk_paged(
            tp, tcfg, t(win).long(), tpool, t(bt), t(lens), t(nv),
            compute_dtype=torch.float32, impl=impl, scheme=scheme)
        assert out is tpool and got.shape == want.shape
        for b in range(3):        # positions past n_valid are never read
            np.testing.assert_allclose(got[b, :nv[b]].numpy(),
                                       want[b, :nv[b]], rtol=1e-5,
                                       atol=1e-5)
        _assert_pools_match(jcfg, jpool, tcfg, tpool)


def test_sample_window_draws_plain_decodes_keys():
    """Row (b, j) of a verify window is the token ``sample_tokens`` draws
    for that row alone at position poss[b] + j, greedy and seeded."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 4, 50, generator=g)
    rids, poss = torch.tensor([0, 7, 2]), torch.tensor([5, 11, 0])
    for kw in (dict(temperature=0.0), SAMPLED):
        got = sample_window(logits, rids, poss, **kw)
        assert got.shape == (3, 4)
        for b in range(3):
            for j in range(4):
                one = sample_tokens(logits[b, j][None], rids[b:b + 1],
                                    poss[b:b + 1] + j, **kw)
                assert int(got[b, j]) == int(one[0])


# ----------------------------------------------------------- engine level --


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_identity_draft_matches_jax_and_accepts_all(models_pair, k):
    _, teng = _spec_pair(models_pair, _default, spec_k=k, draft="self")
    s = teng.summary()
    assert teng.stats.spec_drafted > 0
    assert s["spec_accept_rate"] == 1.0 and s["spec_mean_emitted"] > 1.0
    assert teng.stats.spec_rounds < sum(g for _, g, _ in DEFAULT)
    assert teng.draft_params is teng.params      # the prepared tree
    assert s["spec_compiles"] == 2               # one verify + the draft


@pytest.mark.parametrize("scheme", ["seq", "rc", "ru", "auto"])
def test_spec_shallow_draft_greedy_matches_jax(models_pair, scheme):
    _, teng = _spec_pair(models_pair, _default, spec_k=2, draft=2,
                         scheme=scheme)
    # the shallow draft gets rejections here: the rewind runs
    assert teng.stats.spec_accepted < teng.stats.spec_drafted


def test_spec_seeded_sampling_matches_jax(models_pair):
    _, ident = _spec_pair(models_pair, _default, spec_k=2, draft="self",
                          **SAMPLED)
    assert ident.stats.spec_accepted == ident.stats.spec_drafted
    _, shallow = _spec_pair(models_pair, _default, spec_k=3, draft=2,
                            **SAMPLED)
    assert shallow.stats.spec_accepted < shallow.stats.spec_drafted


@pytest.mark.parametrize("draft", [2, "self"])
def test_spec_on_the_kernel_path_matches_the_gathered_view(models_pair,
                                                           draft):
    """``impl='kernel'`` (K1 for the draft, K2 for the verify and the
    chunks) gives the gathered view's tokens and counters."""
    want = _run(models_pair, "torch", _default, spec_k=2, draft=draft)
    got = _run(models_pair, "torch", _default, spec_k=2, draft=draft,
               impl="kernel")
    assert got[1] == want[1] == _plain(models_pair, _default)
    assert _counters(got[0]) == _counters(want[0])


def test_spec_budget_clipping_matches_jax(models_pair):
    """max_new < k + 1: the window clips to the remaining budget, tokens
    stay identical and never overshoot max_new."""
    reqs_fn = lambda R, S, v: _reqs(R, S, v, BUDGET)
    _, teng = _spec_pair(models_pair, reqs_fn, spec_k=3, draft="self")
    out = _outputs(teng)
    assert all(len(out[i]) == g for i, (_, g, _) in enumerate(BUDGET))


def test_spec_preemption_replay_matches_jax(models_pair):
    """A request preempted mid-generation under spec decoding replays to
    plain decode's tokens (position-keyed sampling, window-aware
    growth); the roomy pool's run agrees too."""
    big = _run(models_pair, "torch", _preempt_reqs, spec_k=2, draft=2,
               **SAMPLED)[1]
    _, teng = _spec_pair(models_pair, _preempt_reqs, num_blocks=7, spec_k=2,
                         draft=2, **SAMPLED)
    assert teng.stats.preemptions > 0
    assert big == _outputs(teng)


def _trie_paths(node, acc=()):
    out = []
    for key, child in node.children.items():
        path = acc + key
        out.append((child.block, path))
        out.extend(_trie_paths(child, path))
    return out


def test_spec_rejections_leave_no_stale_prefix_blocks(models_pair):
    """Every registered trie path is a prefix of some request's committed
    stream, refcounts match the live block tables, a second wave
    re-hits the shared preamble, and the trie equals the JAX engine's."""
    reqs_fn = lambda R, S, v: _reqs(R, S, v, STALE, shared_prefix=8)
    jeng, teng = _spec_pair(models_pair, reqs_fn, spec_k=2, draft=2)
    assert teng.stats.spec_accepted < teng.stats.spec_drafted
    assert teng.summary()["prefix_hit_rate"] > 0
    streams = [list(r.prompt) + [int(t) for t in r.output]
               for r in teng.sched.finished]
    paths = _trie_paths(teng.sched.prefix.root)
    for block, path in paths:
        assert any(list(path) == s[:len(path)] for s in streams), \
            f"block {block} caches tokens that were never committed"
    live = {}
    for blocks in teng.sched.blocks_of.values():
        for b in blocks:
            live[b] = live.get(b, 0) + 1
    teng.sched.prefix.check_invariants(live)
    jpaths = [(b, tuple(int(t) for t in p))
              for b, p in _trie_paths(jeng.sched.prefix.root)]
    assert sorted((b, tuple(int(t) for t in p)) for b, p in paths) == \
        sorted(jpaths)


def test_spec_draft_pool_under_cow_matches_jax(models_pair):
    """CoW copies reach both pools: the identity draft still accepts
    every draft through prefix sharing and second-wave admission, and
    both pools hold the JAX engine's latents (block 0 aside)."""
    reqs_fn = lambda R, S, v: _reqs(R, S, v, COW, shared_prefix=8)
    jeng, teng = _spec_pair(models_pair, reqs_fn, spec_k=2, draft="self")
    assert teng.stats.spec_accepted == teng.stats.spec_drafted
    assert teng.summary()["prefix_hit_tokens"] > 0
    # the JAX engine writes each pool with its jitted steps; the port's
    # eager writes match them to f32 noise
    _assert_pools_match(jeng.cfg, jeng.pool, teng.cfg, teng.pool)
    _assert_pools_match(jeng.draft_cfg, jeng.draft_pool, teng.draft_cfg,
                        teng.draft_pool)


# ------------------------------------------------------- port-only surfaces --


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
def test_async_spec_engine_matches_sync(models_pair, sampling):
    kw = dict(SAMPLED) if sampling == "seeded" else {}
    k = 3 if kw else 2
    sync, want = _run(models_pair, "torch", _default, spec_k=k, draft=2,
                      **kw)
    eng = _torch_engine(models_pair, spec_k=k, draft=2, cls=TAsync, **kw)
    eng.run(_default(TRequest, TSP, models_pair[1].vocab))
    assert eng.idle and _outputs(eng) == want
    assert _counters(eng) == _counters(sync)
    assert want == _plain(models_pair, _default, **kw)


def test_frontend_serves_a_spec_engine(models_pair):
    """One blocking request through ``launch.server.Frontend`` on a spec
    engine gives a direct run's tokens."""
    prompt = [5, 9, 3, 7, 11, 2]
    direct = _torch_engine(models_pair, spec_k=2, draft=2)
    direct.run([TRequest(rid=0, prompt=np.asarray(prompt, np.int32),
                         sampling=TSP(max_tokens=6))])
    served = _torch_engine(models_pair, spec_k=2, draft=2)
    fe = TFrontend(served, port=0).start()
    try:
        req = urllib.request.Request(
            f"http://{fe.host}:{fe.port}/v1/generate",
            json.dumps({"prompt": prompt, "max_tokens": 6}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
    finally:
        fe.stop()
    assert body["output"] == _outputs(direct)[0]
    assert served.stats.spec_rounds > 0


def test_spec_telemetry_spans_and_verify_drift(models_pair):
    """With telemetry on, every spec tick nests draft / verify /
    host_sample spans under its step, the trace validates, and the drift
    channel holds one verify row a round; EngineStats as with it off."""
    tel = Telemetry.on(trace=True, metrics=True, drift=True)
    eng = _torch_engine(models_pair, spec_k=2, draft=2, scheme="auto",
                        telemetry=tel)
    eng.run(_default(TRequest, TSP, models_pair[1].vocab))
    off = _run(models_pair, "torch", _default, spec_k=2, draft=2,
               scheme="auto")[0]
    assert _counters(eng) == _counters(off)
    tel.finalize(eng)
    trace = tel.tracer.to_dict()
    assert validate_trace(trace) == []
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    rounds = eng.stats.spec_rounds
    assert names.count("draft") == names.count("verify") == rounds
    assert "device_step" not in names
    verify = [r for r in tel.drift.rows if r.kind == "verify"]
    assert len(verify) == rounds
    assert tel.drift.report()["rows"]
    assert not tel.drift.check_coverage(eng.stats.schemes_used,
                                        kinds=("verify",))


def test_serve_cli_speculative_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--paged", "--impl", "kernel",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                 "--gen", "5", "--spec-k", "3", "--draft", "shallow:2"])
    out = capsys.readouterr().out
    assert "speculative decoding: k=3, draft=shallow:2 (2 layers)" in out
    assert "[serve] paged: 8 decode tokens" in out
    assert "[serve] spec decode:" in out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--spec-k", "2"])               # needs --paged
