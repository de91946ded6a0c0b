"""Seeded sampling in the port against the JAX package: the sampler
(``runtime.steps.sample_tokens``) against the JAX engine's, and the paged
engine's tokens under temperature / top-k sampling identical to the JAX
engine's — with prefix hits, recompute preemption (a small pool) and an
n = 3 fork group — on the f32 smoke config at drop-free MoE capacity.

Gumbel noise differs from XLA's by an ulp in some elements (the two
logarithms; tests/test_torch_prng.py), so a token could flip only where a
row's two best perturbed scores lie within ~1e-6 of each other; the
seeds here have no such row.
"""
import dataclasses

import jax.numpy as jnp
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
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.runtime.steps import sample_tokens
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
SAMPLING = [dict(temperature=0.8, top_k=5, sample_seed=3),
            dict(temperature=1.0, top_k=0, sample_seed=1)]


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


def _engine(Engine, platforms, cfg, params, num_blocks=64, **kw):
    return Engine(cfg, params, num_blocks=num_blocks, block_size=4,
                  max_batch=4, max_blocks_per_req=16, scheme="auto",
                  platform=platforms["h100"], prefill_chunk=8, **kw)


def _requests(Req, SP, vocab):
    """A shared 20-token preamble (prefix hits), an n = 3 fork group
    (rids 3, 4, 5), staggered arrivals."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 20)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               for n in (5, 9, 13)] + [rng.integers(0, vocab, 7)]
    return [Req(rid=3 * i, prompt=p, arrival=i,
                sampling=SP(max_tokens=10, n=3 if i == 1 else 1))
            for i, p in enumerate(prompts)]


def _outs(eng):
    return {r.rid: (list(r.output), r.finish_reason)
            for r in eng.sched.finished}


# ------------------------------------------------------------- sampler --


@pytest.mark.parametrize("kw", SAMPLING + [dict(temperature=0.0)])
def test_sampler_matches_the_jax_engines(models_pair, kw):
    """Rows of random logits (with ties at the top-k cut) through the
    JAX engine's sampler and the port's: the same token per row."""
    jcfg, _, jp, _ = models_pair
    jeng = _engine(JEngine, JPLATFORMS, jcfg, jp, **kw)
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((32, 300)).astype(np.float32) * 3
    rows[:8, 10:14] = rows[:8].max() + 1.0       # four tied maxima
    rids = rng.integers(0, 1000, 32)
    poss = rng.integers(0, 4000, 32)
    if kw["temperature"] > 0:
        want = jeng._sample_rows(jnp.asarray(rows), rids.tolist(),
                                 poss.tolist())
    else:
        want = np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1))
    got = sample_tokens(torch.from_numpy(rows), torch.from_numpy(rids),
                        torch.from_numpy(poss), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_keeps_ties():
    """The cut keeps every logit >= the k-th largest: with four tied
    maxima and top_k = 2 all four are drawn, and nothing else is."""
    rows = torch.zeros((1, 50))
    rows[0, [3, 17, 30, 41]] = 5.0
    rows = rows.expand(400, -1)
    toks = sample_tokens(rows, torch.zeros(400, dtype=torch.int64),
                         torch.arange(400), temperature=1.0, top_k=2,
                         sample_seed=0)
    assert set(toks.tolist()) == {3, 17, 30, 41}


# -------------------------------------------------------------- engine --


@pytest.mark.parametrize("kw", SAMPLING)
@pytest.mark.parametrize("num_blocks,impl", [(64, "kernel"), (14, "ref")])
def test_engine_sampled_tokens_match_jax(models_pair, kw, num_blocks, impl):
    """Seeded temperature / top-k tokens identical to the JAX engine's,
    with prefix hits and an n = 3 fork; num_blocks = 14 forces recompute
    preemption, whose replay draws the same (rid, position) keys."""
    jcfg, tcfg, jp, tp = models_pair
    jeng = _engine(JEngine, JPLATFORMS, jcfg, jp, num_blocks=num_blocks,
                   **kw)
    jsum = jeng.run(_requests(JRequest, JSP, jcfg.vocab))
    teng = _engine(TEngine, TPLATFORMS, tcfg, tp, num_blocks=num_blocks,
                   impl=impl, device="cpu", **kw)
    tsum = teng.run(_requests(TRequest, TSP, tcfg.vocab))
    assert _outs(teng) == _outs(jeng)
    for k in ("preemptions", "prefix_hit_tokens", "fork_children",
              "decode_tokens", "schemes_used"):
        assert tsum[k] == jsum[k], k
    assert tsum["fork_children"] == 2 and tsum["prefix_hit_tokens"] > 0
    if num_blocks == 14:
        assert tsum["preemptions"] > 0
    # the fork group's members diverge under sampling
    outs = _outs(teng)
    assert len({tuple(outs[r][0]) for r in (3, 4, 5)}) > 1


def test_fork_group_equals_consecutive_rids(models_pair):
    """An n = 3 group (one prefill, CoW fork) emits exactly the tokens of
    3 independent requests on consecutive rids, with fewer blocks."""
    _, tcfg, _, tp = models_pair
    kw = dict(temperature=0.9, top_k=5, sample_seed=7, device="cpu",
              impl="kernel")
    prompt = np.random.default_rng(11).integers(0, tcfg.vocab, 16)
    grp = _engine(TEngine, TPLATFORMS, tcfg, tp, **kw)
    grp.run([TRequest(rid=0, prompt=prompt,
                      sampling=TSP(max_tokens=6, n=3))])
    ind = _engine(TEngine, TPLATFORMS, tcfg, tp, **kw)
    ind.run([TRequest(rid=i, prompt=prompt, sampling=TSP(max_tokens=6))
             for i in range(3)])
    assert _outs(grp) == _outs(ind) and len(_outs(grp)) == 3
    assert len({tuple(t) for t, _ in _outs(grp).values()}) > 1
    assert grp.sched.allocator.total_allocs < ind.sched.allocator.total_allocs
    assert grp.summary()["fork_children"] == 2.0


def test_preemption_replay_draws_the_same_tokens(models_pair):
    """Recompute preemption re-prefills the generated tokens and keeps
    drawing at the same absolute positions: a pool too small for both
    requests gives the tokens of a pool that fits them."""
    _, tcfg, _, tp = models_pair
    kw = dict(temperature=0.7, top_k=8, sample_seed=1, device="cpu",
              impl="kernel")
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, tcfg.vocab, 6) for _ in range(2)]

    def reqs():
        return [TRequest(rid=i, prompt=p, sampling=TSP(max_tokens=10))
                for i, p in enumerate(prompts)]

    big = _engine(TEngine, TPLATFORMS, tcfg, tp, num_blocks=40, **kw)
    big.run(reqs())
    # 6 usable blocks of 4 tokens cannot hold 2 x (6 prompt + 10 gen)
    small = _engine(TEngine, TPLATFORMS, tcfg, tp, num_blocks=7, **kw)
    small.run(reqs())
    assert small.stats.preemptions > 0
    assert _outs(small) == _outs(big)


def test_validate_sampling_raises_where_the_reference_does(models_pair):
    jcfg, tcfg, jp, tp = models_pair
    kw = dict(temperature=0.8, top_k=5, sample_seed=7)
    engines = [(_engine(JEngine, JPLATFORMS, jcfg, jp, **kw), JRequest, JSP),
               (_engine(TEngine, TPLATFORMS, tcfg, tp, device="cpu", **kw),
                TRequest, TSP)]
    ids = np.arange(6, dtype=np.int32)
    for eng, Req, SP in engines:
        eng.validate_sampling(None)
        eng.validate_sampling(SP(max_tokens=2))
        eng.validate_sampling(SP(max_tokens=2, temperature=0.8, top_k=5,
                                 seed=7))
        for bad in (dict(temperature=0.3), dict(top_k=9), dict(seed=1),
                    dict(temperature=0.0)):
            with pytest.raises(ValueError, match="engine"):
                eng.submit(Req(rid=0, prompt=ids,
                               sampling=SP(max_tokens=2, **bad)))
