"""Parity of the port's host runtime and serving engine with the JAX
package: scheduler / radix trie / refcounts under a differential drive,
the cost model and scheme dispatch, and ``PagedMLAEngine`` end to end —
logits within 1e-4 (f32, four layers of ~1e-7 reduction-order noise) and
greedy tokens identical, with prefix-cache hits, a forced recompute
preemption, an n=2 fork, stop sequences and cancel.  Also: the port
imports without jax, unported options raise, and the serving CLI runs
(paged and contiguous).

The smoke config runs at drop-free MoE capacity (capacity_factor =
n_experts / top_k, as the JAX package's serving benchmark does): below
it, token dropping depends on the batch's idle rows, which the two
attention paths fill differently.
"""
import dataclasses
import subprocess
import sys
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.core import schemes as jschemes
from repro.hwmodel import attention_costs as jac
from repro.hwmodel.platforms import PLATFORMS as JPLATFORMS
from repro.runtime import PagedMLAEngine as JEngine
from repro.runtime import Request as JRequest
from repro.runtime import SamplingParams as JSP
from repro.runtime.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as tconfigs
from repro_torch.core import mla as tmla
from repro_torch.core import schemes as tschemes
from repro_torch.hwmodel import attention_costs as tac
from repro_torch.hwmodel.platforms import PLATFORMS as TPLATFORMS
from repro_torch.launch import serve as tserve
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.runtime.scheduler import ContinuousScheduler as TScheduler
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

# the suite runs in parallel worker processes: a small intra-op pool
# keeps these tests from crowding the others (and is faster at this size)
torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


# ------------------------------------------------ scheduler differential --


def _state(s):
    return (s.block_table.tolist(), s.lengths.tolist(),
            dict(s.allocator.refcount), sorted(s.allocator._free),
            sorted(s.prefix._node_of), sorted(s.prefix._evictable),
            [r.rid for r in s.waiting],
            [None if r is None else (r.rid, list(r.tokens)) for r in s.slots],
            sorted((r.rid, r.finish_reason, list(r.output))
                   for r in s.finished))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_differential_drive(seed):
    """The same random traffic (submits with shared preambles and n-way
    groups, admissions, decode ticks with preemption, CoW drains,
    eviction, cancels, stop sequences) through both packages' schedulers:
    block tables, lengths, refcounts, free lists, trie contents, queues,
    admission order and outputs agree after every op."""
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=int(rng.integers(6, 16)),
              block_size=int(rng.integers(2, 5)),
              max_batch=int(rng.integers(1, 4)),
              admission=("fcfs", "cache_aware")[seed % 2])
    pair = [(JScheduler(**kw), JRequest, JSP), (TScheduler(**kw), TRequest,
                                                 TSP)]
    pool_tokens = (kw["num_blocks"] - 1) * kw["block_size"]
    rid = 0
    for step in range(150):
        op = int(rng.integers(0, 6))
        outs = []
        if op == 0:
            plen = int(rng.integers(1, max(pool_tokens // 2, 2)))
            prompt = np.concatenate([
                np.zeros(min(plen, 4), np.int32),
                rng.integers(0, 3, max(plen - 4, 0)).astype(np.int32)])
            gen = int(rng.integers(1, 6))
            n = int(rng.integers(2, 4)) if rng.integers(0, 3) == 0 else 1
            if n > kw["max_batch"] or n * (-(-(plen + gen + 1)
                                             // kw["block_size"])) \
                    > kw["num_blocks"] - 1:
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
            toks = {sl: int(rng.integers(0, 3)) for sl in range(8)}
            for s, _, _ in pair:
                pre = [r.rid for r in s.ensure_step_capacity()]
                cow = s.drain_cow()
                fin = [r.rid for r in s.advance(
                    {sl: toks[sl] for sl in s.active_slots}, step)]
                outs.append((pre, cow, fin))
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


# --------------------------------------------------- cost model + dispatch --


def test_scheme_dispatch_and_costs_match_jax():
    jm = jconfigs.full(ARCH).mla_config()
    tm = tconfigs.full(ARCH).mla_config()
    for plat in ("h100", "tpu_v5e", "a100"):
        jp, tp = JPLATFORMS[plat], TPLATFORMS[plat]
        for cd in (None, "int8"):
            for batch in (1, 8, 64):
                for L in (256, 4096, 65536):
                    kw = dict(cache_len=L, batch=batch, paged_block=16,
                              cache_dtype=cd)
                    assert tschemes.auto_dispatch(tm, tp, **kw) == \
                        jschemes.auto_dispatch(jm, jp, **kw)
                    for s in ("seq", "rc", "ru", "naive"):
                        assert tschemes.step_time(s, tm, tp, **kw) == \
                            jschemes.step_time(s, jm, jp, **kw)
                    for s in ("seq", "rc", "ru", "naive"):
                        a = tac.mla_decode_cost(
                            tm, scheme=s, cache_len=L, batch=batch,
                            paged_block=16, rope=True)
                        b = jac.mla_decode_cost(
                            jm, scheme=s, cache_len=L, batch=batch,
                            paged_block=16, rope=True)
                        assert (a.flops, a.bytes, a.breakdown) == \
                            (b.flops, b.bytes, b.breakdown)


# ------------------------------------------------------------ the engine --


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


def _requests(Req, SP, vocab):
    """A shared 20-token preamble (prefix hits), a 2-way fork group, a
    stop sequence, staggered arrivals."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 20)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               for n in (5, 9, 13)] + [rng.integers(0, vocab, 7)]
    return [Req(rid=2 * i, prompt=p, arrival=i,
                sampling=SP(max_tokens=10, n=2 if i == 1 else 1,
                            stop=((3, 4),) if i == 3 else ()))
            for i, p in enumerate(prompts)]


def _run(Engine, Req, SP, platforms, cfg, params, rows=None, cancel=None,
         **kw):
    eng = Engine(cfg, params, block_size=4, max_batch=3,
                 max_blocks_per_req=16, scheme="auto",
                 platform=platforms["h100"], prefill_chunk=8, **kw)
    if rows is not None:            # record every logits row sampled
        orig = eng._sample_tokens

        def record(r, slots):
            rows.append((list(slots), np.asarray(r, np.float32)))
            return orig(r, slots)
        eng._sample_tokens = record
    reqs = _requests(Req, SP, cfg.vocab)
    if cancel is None:
        summary = eng.run(reqs)
    else:                           # cancel rid 4 once it has 3 tokens
        for r in reqs:
            eng.submit(r)
        while not eng.idle:
            eng.step()
            live = [s for s in eng.sched.slots if s is not None]
            if any(r.rid == cancel and len(r.tokens) >= 3 for r in live):
                eng.request_cancel(cancel)
        summary = eng.summary()
    out = {r.rid: (list(r.output), r.finish_reason)
           for r in eng.sched.finished}
    return out, summary


@pytest.mark.parametrize("num_blocks,cancel", [(64, None), (14, None),
                                               (64, 4)])
def test_engine_tokens_and_logits_match_jax(models_pair, num_blocks, cancel):
    """Greedy tokens identical to the JAX engine for both attention paths;
    every sampled logits row within 1e-4; the same prefix hits,
    preemptions (num_blocks=14 forces recompute preemption), forks, stop
    and cancel outcomes."""
    jcfg, tcfg, jp, tp = models_pair
    jrows = []
    want, jsum = _run(JEngine, JRequest, JSP, JPLATFORMS, jcfg, jp,
                      rows=jrows, cancel=cancel, num_blocks=num_blocks)
    for impl in ("ref", "kernel"):
        trows = []
        got, tsum = _run(TEngine, TRequest, TSP, TPLATFORMS, tcfg, tp,
                         rows=trows, cancel=cancel, num_blocks=num_blocks,
                         impl=impl, device="cpu")
        assert got == want
        for k in ("preemptions", "prefix_hit_tokens", "schemes_used",
                  "prefill_chunks", "decode_tokens", "fork_children"):
            assert tsum[k] == jsum[k], k
        assert [s for s, _ in trows] == [s for s, _ in jrows]
        for (_, a), (_, b) in zip(trows, jrows):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    assert jsum["prefix_hit_tokens"] > 0 and jsum["fork_children"] == 1
    if num_blocks == 14:
        assert jsum["preemptions"] > 0
    if cancel is not None:
        assert want[cancel][1] == "cancelled"


def test_engine_rejects_what_is_not_ported(models_pair):
    """What a mesh does not run yet raises, naming ROADMAP.md: CUDA
    graphs and speculative decoding under a mesh (mesh serving itself is
    ported: tests/test_torch_mesh.py); sampling knobs that differ from
    the engine's raise ValueError, as in the reference (seeded sampling,
    telemetry and speculative decoding are ported:
    tests/test_torch_sampling.py, tests/test_torch_obs.py,
    tests/test_torch_spec.py)."""
    _, tcfg, _, tp = models_pair
    kw = dict(num_blocks=8, block_size=4, max_batch=2, scheme="seq",
              device="cpu")
    for refused in (dict(cuda_graphs=True), dict(spec_k=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(tcfg, tp, **kw, mesh=object(), **refused)
    with pytest.raises(ValueError):
        TEngine(tcfg, tp, **dict(kw, scheme="auto"))      # no platform
    eng = TEngine(tcfg, tp, **kw)                         # greedy
    for sp in (dict(temperature=0.5), dict(top_k=5), dict(seed=3)):
        with pytest.raises(ValueError):
            eng.submit(TRequest(rid=0, prompt=[1, 2],
                                sampling=TSP(max_tokens=2, **sp)))


# ------------------------------------------------------- package hygiene --


def test_import_without_jax():
    """The port imports with jax blocked, and imports nothing of repro."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.runtime, repro_torch.weights, "
            "repro_torch.launch.serve, repro_torch.kernels.ops, "
            "repro_torch.hwmodel, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.obs, repro_torch.hwmodel.roofline, "
            "repro_torch.runtime.prng, repro_torch.runtime.spec, "
            "repro_torch.configs.deepseek_v3_671b; "
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m.split('.')[0] in ('repro', 'jax', 'jaxlib'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--paged", "--impl", "kernel",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                 "--gen", "4", "--n", "2"])
    out = capsys.readouterr().out
    assert "[serve] paged: 12 decode tokens" in out
    assert "2 groups forked" in out
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "9", "--gen", "4"])  # contiguous
    assert "[serve] decoded 3 steps" in capsys.readouterr().out


def test_absorbed_tree_is_a_copy(models_pair):
    _, tcfg, _, tp = models_pair
    out = tmla.attach_absorbed_tree(tp, tcfg.mla_config())
    assert "w_absorb" in out["period"][0]["s0"]["attn"]
    assert "w_absorb" not in tp["period"][0]["s0"]["attn"]
    assert torch.equal(out["embed"]["table"], tp["embed"]["table"])
    jax.tree_util.tree_leaves(out)      # a plain tree of tensors
