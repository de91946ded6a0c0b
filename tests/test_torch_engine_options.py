"""The paged engines' cold-cache options and ``impl='chunked'`` against
the JAX package, on the f32 DeepSeek-V2 smoke config at drop-free MoE
capacity (``capacity_factor = n_experts / top_k``), on the CPU.

The load is a small conversation tree (block size 4): three
conversations open with one 10-token system prompt, which ends two
tokens into block 3, and add 5 tokens each; conversation 0 arrives
alone and the others once its prefill has finished, so they hit its
blocks, the last one partially.  Each reply is 6 tokens; the second
turn appends the reply and a 3-token user suffix, so it hits the blocks
the first turn's decode completed.

Under every combination of ``decode_block_reuse`` x ``partial_match`` x
``admission`` the port's synchronous and asynchronous engines make the
JAX engine's host decisions (the block table and lengths after every
tick, the prefix-cache counters, the prefill tokens) and emit its greedy
tokens, exactly.  ``impl='chunked'`` serves, in chunked and per-request
prefill, the JAX engine's ``impl='chunked'`` tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.hwmodel.platforms import PLATFORMS as JPLATFORMS
from repro.runtime import PagedMLAEngine as JEngine
from repro.runtime import Request as JRequest
from repro.runtime import SamplingParams as JSP
import repro_torch.configs as tconfigs
from repro_torch.hwmodel.platforms import PLATFORMS as TPLATFORMS
from repro_torch.launch import serve as tserve
from repro_torch.runtime import AsyncPagedMLAEngine as TAsync
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
# the host's decisions the two packages must share
HOST = ("steps", "prefill_tokens", "prompt_tokens", "prefill_chunks",
        "admissions", "mid_gen_admissions", "preemptions",
        "prefix_hit_tokens", "prefix_partial_hits",
        "prefix_decode_inserted_blocks", "total_blocks_allocated")
OPTIONS = {f"reuse{int(r)}-partial{int(p)}-{a}":
           dict(decode_block_reuse=r, partial_match=p, admission=a)
           for r in (True, False) for p in (True, False)
           for a in ("cache_aware", "fcfs")}


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


def _engine(Engine, platforms, cfg, params, **kw):
    return Engine(cfg, params, num_blocks=64, block_size=4, max_batch=4,
                  max_blocks_per_req=10, scheme="seq",
                  platform=platforms["h100"], prefill_chunk=4, **kw)


def _drive_turns(eng, Req, SP, vocab, turns=2):
    """Serve the conversation tree turn by turn on one engine.  Returns
    the outputs by rid, the (block table, lengths) after every tick, the
    summary and the prefill tokens of each turn."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 10)
    prompts = [np.concatenate([system, rng.integers(0, vocab, 5)])
               for _ in range(3)]
    suffixes = [[rng.integers(0, vocab, 3) for _ in range(3)]
                for _ in range(turns)]
    outs, ticks, per_turn = {}, [], []
    for t in range(turns):
        start, prefilled = eng.stats.steps, eng.stats.prefill_tokens
        # turn 1: conversation 0 alone, the others after its prefill
        reqs = [Req(rid=10 * t + i, prompt=p,
                    arrival=start + (5 if t == 0 and i else 0),
                    sampling=SP(max_tokens=6))
                for i, p in enumerate(prompts)]
        todo = list(reqs)
        while todo or not eng.idle:
            while todo and todo[0].arrival <= eng.stats.steps:
                eng.submit(todo.pop(0))
            eng.step()
            ticks.append((eng.sched.block_table.copy(),
                          eng.sched.lengths.copy()))
            assert eng.stats.steps < start + 200
        for r in reqs:
            outs[r.rid] = list(map(int, r.output))
        per_turn.append(eng.stats.prefill_tokens - prefilled)
        prompts = [np.concatenate([p, outs[r.rid], suffixes[t][i]])
                   for i, (p, r) in enumerate(zip(prompts, reqs))]
    return outs, ticks, eng.summary(), per_turn


@pytest.mark.parametrize("opts", OPTIONS)
def test_engine_options_match_jax(models_pair, opts):
    jcfg, tcfg, jp, tp = models_pair
    kw = OPTIONS[opts]
    j_out, j_ticks, j_sum, j_turns = _drive_turns(
        _engine(JEngine, JPLATFORMS, jcfg, jp, **kw), JRequest, JSP,
        jcfg.vocab)
    for Engine in (TEngine, TAsync):
        t_out, t_ticks, t_sum, t_turns = _drive_turns(
            _engine(Engine, TPLATFORMS, tcfg, tp, device="cpu",
                    impl="kernel", **kw), TRequest, TSP, tcfg.vocab)
        assert t_out == j_out, Engine.__name__
        assert t_turns == j_turns
        assert {k: t_sum[k] for k in HOST} == {k: j_sum[k] for k in HOST}
        assert len(t_ticks) == len(j_ticks)
        for i, ((tb, tl), (jb, jl)) in enumerate(zip(t_ticks, j_ticks)):
            np.testing.assert_array_equal(tb, jb, err_msg=f"tick {i}")
            np.testing.assert_array_equal(tl, jl, err_msg=f"tick {i}")
    # each switch does what it says on this load
    assert (j_sum["prefix_partial_hits"] > 0) == kw["partial_match"]
    assert (j_sum["prefix_decode_inserted_blocks"] > 0) == \
        kw["decode_block_reuse"]
    if kw["decode_block_reuse"] and kw["partial_match"]:
        cold = OPTIONS["reuse0-partial0-fcfs"]
        _, _, _, c_turns = _drive_turns(
            _engine(TEngine, TPLATFORMS, tcfg, tp, device="cpu", **cold),
            TRequest, TSP, tcfg.vocab)
        assert j_turns[1] < c_turns[1]


def test_prefix_reuse_after_release_warm_and_cold(models_pair):
    """The port's copy of the JAX package's
    ``test_engine_prefix_reuse_after_release``: an 11-token prompt twice,
    strictly one after the other.  Warm (the defaults) the second
    request hits 2 full blocks and 2 tokens of the block request 0's
    decode completed, and re-prefills one token; cold (no partial
    match, no decode-block reuse, FCFS) it hits the 8 block-aligned
    tokens and re-prefills 3.  Both engines of both packages agree."""
    jcfg, tcfg, jp, tp = models_pair
    prompt = np.random.default_rng(7).integers(0, tcfg.vocab, 11)
    cold = dict(partial_match=False, decode_block_reuse=False,
                admission="fcfs")
    outs = []
    for kw, hits, prefilled in (({}, 8 + 2, 11 + 1), (cold, 8, 11 + 3)):
        for Engine, Req, SP, cfg, p, extra in (
                (JEngine, JRequest, JSP, jcfg, jp, {}),
                (TEngine, TRequest, TSP, tcfg, tp, dict(device="cpu")),
                (TAsync, TRequest, TSP, tcfg, tp, dict(device="cpu"))):
            eng = Engine(cfg, p, num_blocks=40, block_size=4, max_batch=2,
                         scheme="seq", prefill_chunk=4, **kw, **extra)
            eng.run([Req(rid=i, prompt=prompt.copy(), arrival=6 * i,
                         sampling=SP(max_tokens=3)) for i in range(2)])
            s = eng.summary()
            assert s["prefix_hit_tokens"] == hits, Engine.__name__
            assert s["prefix_partial_hits"] == (1 if not kw else 0)
            assert s["prefix_decode_inserted_blocks"] == (1 if not kw else 0)
            assert s["prefill_tokens"] == prefilled
            o = {r.rid: list(map(int, r.output)) for r in eng.sched.finished}
            assert o[0] == o[1]
            outs.append(o)
    assert all(o == outs[0] for o in outs)


@pytest.mark.parametrize("prefill_chunk", [4, 0], ids=["chunked",
                                                       "per_request"])
def test_impl_chunked_matches_jax(models_pair, prefill_chunk):
    """``impl='chunked'`` on the paged engines: decode and chunks gather,
    a per-request prefill walks ``core.chunked_attention``'s block pairs;
    greedy tokens equal the JAX engine's ``impl='chunked'`` on both
    engines, and the synchronous engine's under 'ref' and 'kernel'."""
    jcfg, tcfg, jp, tp = models_pair
    mode = "chunked" if prefill_chunk else "per_request"
    kw = dict(prefill_mode=mode, prefill_chunk=prefill_chunk or 4)

    def engine(Engine, platforms, cfg, params, **extra):
        return Engine(cfg, params, num_blocks=64, block_size=4, max_batch=4,
                      max_blocks_per_req=10, scheme="seq",
                      platform=platforms["h100"], **kw, **extra)

    want = _drive_turns(engine(JEngine, JPLATFORMS, jcfg, jp,
                               impl="chunked"), JRequest, JSP, jcfg.vocab)
    for Engine, impl in ((TEngine, "chunked"), (TAsync, "chunked"),
                         (TEngine, "ref"), (TEngine, "kernel")):
        eng = engine(Engine, TPLATFORMS, tcfg, tp, impl=impl, device="cpu")
        assert eng.impl == impl
        got = _drive_turns(eng, TRequest, TSP, tcfg.vocab)
        assert got[0] == want[0], (Engine.__name__, impl)
        assert {k: got[2][k] for k in HOST} == {k: want[2][k] for k in HOST}


def test_serve_cli_paged_chunked_and_cold_options(models_pair, capsys):
    """``launch/serve.py --paged --impl chunked`` serves (it was refused
    before the engines took 'chunked'), with the sample line of
    ``--impl ref``; ``build_engine`` passes the two cold-cache options
    to the scheduler."""
    lines = []
    for impl in ("chunked", "ref"):
        tserve.main(["--arch", ARCH, "--smoke", "--paged", "--impl", impl,
                     "--device", "cpu"])
        lines.append([x for x in capsys.readouterr().out.splitlines()
                      if x.startswith("[serve] sample:")])
    assert lines[0] and lines[0] == lines[1]
    _, tcfg, _, tp = models_pair
    eng = tserve.build_engine(tcfg, tp, batch=2, max_len=16, device="cpu",
                              decode_block_reuse=False, partial_match=False)
    assert not eng.sched.decode_block_reuse
    assert not eng.sched.prefix.partial
    with pytest.raises(ValueError, match="unknown impl"):
        tserve.build_engine(tcfg, tp, batch=2, max_len=16, device="cpu",
                            impl="dense")
